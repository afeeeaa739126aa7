"""Weight bridge into the port, written without jax.

`state_dict_from_jax(params)` turns the JAX package's EncoderDecoder params
tree (nested dicts of numpy arrays, as `jax.tree.map(np.asarray,
variables["params"])` gives) into the port's state_dict, whose keys are
the reference torch scheme. It is the inverse of the key map of
`sigma_tpu/utils/convert.py::convert_sigma_full`:

  flax Dense kernel (in, out)      -> Linear weight (out, in)
  flax Conv kernel (kh, kw, I, O)  -> Conv2d weight (O, I, kh, kw)
  Dense feeding a 1x1 conv (CAB attention, classifier)
                                   -> Conv2d weight (O, I, 1, 1)
  x_proj_weight (K, D, C)          -> (K, C, D)
  dt_projs_weight (K, R, D)        -> (K, D, R)
  LayerNorm / BatchNorm scale, bias -> weight / bias
  BatchNorm batch_stats mean / var -> running_mean / running_var
  nn.scan-stacked stage leaves     -> one tensor per block

The decoders that the reference never trained (SURVEY.md: its non-Mamba
decoders raise) keep the JAX tree's module names (`decode_head.psp.
scale_0.conv.weight`, `aux_head.conv.bn.running_var`, ...).

The ingest half is the port's copy of the JAX package's (its
`load_torch_state_dict`, `_strip`, `_torch_candidates`,
`load_vmamba_into_params` and `load_checkpoint_into_params`), aimed at the
port's module names:

  `load_checkpoint(path)`   the tensors of a `.pth`/`.pt` (envelopes
      `model` / `state_dict` / `module`, the `module.` prefix, non-tensor
      entries dropped) or an `.npz`, read by its key form: torch names
      (`.`-joined) as they are, JAX params flattened with `/`-joined flax
      paths through `state_dict_from_jax`;
  `load_vmamba_into_model(model, path)`   a released VMamba ImageNet
      checkpoint into `model.backbone.vssm`, strict=False: every released
      key variant (`patch_embed.proj` / `patch_embed.0`, `self_attention` /
      `op`, `ln_1` / `norm`) is accepted, a tensor of the wrong shape
      raises, a tensor the file lacks keeps the model's seeded init (the
      `outnorm*` layers), a key the trunk does not have (the classifier) is
      dropped. Given a VSSMClassifier, the file fills the whole classifier, its
      head from `classifier.norm.*` / `classifier.head.*` or the
      published `norm.*` / `head.*`;
  `load_checkpoint_into_model(model, path)`   the dispatch of the eval
      CLI's `-e FILE`: a file whose keys start with `backbone.` /
      `decode_head.` is a full model (the same strict=False rules over
      the whole model), any other file a trunk;
  `load_mit_dualpath(model, path)` / `load_swin_dualpath(model, path)`
      a released single-trunk MiT / Swin ImageNet file into both
      modality paths of the model's dual encoder (the reference's
      `load_dualpath_model`): the MiT trunks' keys are the file's, the
      Swin X path's the same under `patch_embed_d` / `layers_d`; FRM,
      FFM and the out-norms keep their init, the file's head and
      buffers (`relative_position_index`) are dropped.
      `convert_mit_trunk(trunk, sd)` / `convert_swin_dual(encoder, sd)`
      do it on a module.

A `.pth` is read with `torch.load(weights_only=False)`, as the JAX package
reads it: a released checkpoint's envelope pickles objects besides its
tensors (an argparse namespace, a config), so only trusted files may be
given.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from sigma_tpu_torch.engine.logger import get_logger
from sigma_tpu_torch.models.vssm import VSSMClassifier

_T = lambda w: w.T  # noqa: E731
_CONV = lambda w: np.transpose(w, (3, 2, 0, 1))  # noqa: E731
_CONV1x1 = lambda w: w.T[:, :, None, None]  # noqa: E731
_K_T = lambda w: np.transpose(w, (0, 2, 1))  # noqa: E731
_ID = lambda w: w  # noqa: E731

# flax path (slash-joined) -> reference torch key, applied in order
_RULES = [
    (r"/ssm/", "/"),
    (r"patch_embed/proj/", "patch_embed/0/"),
    (r"patch_embed/norm/", "patch_embed/2/"),
    (r"layers_(\d+)_blocks_(\d+)", r"layers/\1/blocks/\2"),
    (r"layers_(\d+)_downsample", r"layers/\1/downsample"),
    (r"(cross_mamba|channel_attn_mamba|layers_up|blocks)_(\d+)", r"\1/\2"),
    (r"conv_blk/conv1/", "conv_blk/cab/0/"),
    (r"conv_blk/conv2/", "conv_blk/cab/2/"),
    (r"conv_blk/attn/fc_0/", "conv_blk/cab/3/fc/0/"),
    (r"conv_blk/attn/fc_1/", "conv_blk/cab/3/fc/2/"),
    (r"/(fc[12])_0/", r"/\1/0/"),
    (r"/(fc[12])_1/", r"/\1/2/"),
    (r"/op/x_proj_([12])$", r"/op/CMA_ssm/x_proj_\1/weight"),
    (r"/op/dt_proj_([12])_(weight|bias)$", r"/op/CMA_ssm/dt_proj_\1/\2"),
    (r"/op/(A_log_[12]|D_[12])$", r"/op/CMA_ssm/\1"),
    (r"/op/(out_norm_[12])/", r"/op/CMA_ssm/\1/"),
    (r"^classifier_(norm|head)/", r"classifier/\1/"),
    (r"/(kernel|scale)$", "/weight"),
]

# the MiT and Swin dual encoders (a `backbone/` path outside the Sigma
# encoder's three subtrees) take these rules instead: the global ones
# would rewrite Swin's `layers_d_0_blocks_1` as a `blocks_(\d+)` list
# and send a patch conv to VMamba's Sequential keys. Their keys are the
# released single-trunk files' (utils/convert.py of the JAX package,
# convert_mit_trunk / convert_swin_dual)
_DUAL_RULES = [
    (r"^backbone/patch_embed(_d)?/", r"backbone/patch_embed\1/proj/"),
    (r"^backbone/patch_norm(_d)?/", r"backbone/patch_embed\1/norm/"),
    (r"/layers(_d)?_(\d+)_blocks_(\d+)/", r"/layers\1/\2/blocks/\3/"),
    (r"/layers(_d)?_(\d+)_downsample/", r"/layers\1/\2/downsample/"),
    (r"/block(\d+)_(\d+)/", r"/block\1/\2/"),
    (r"/(frm|ffm)_(\d+)/", r"/\1/\2/"),
    (r"/attn/sr_norm/", "/attn/norm/"),
    (r"/mlp/dwconv/", "/mlp/dwconv/dwconv/"),
    (r"/(kernel|scale)$", "/weight"),
]
_SIGMA_BACKBONE = re.compile(
    r"backbone/(vssm|cross_mamba_\d+|channel_attn_mamba_\d+)/")


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        path = prefix + (str(k),)
        if isinstance(v, Mapping):
            yield from _flatten(v, path)
        else:
            yield path, np.asarray(v)


def _transform(path: str, leaf: str, ndim: int):
    if leaf == "kernel":
        if "conv_blk/attn/" in path or re.match(
                r"decode_head/output(_ds_\d+)?/", path):
            return _CONV1x1
        return _CONV if ndim == 4 else _T
    if leaf in ("x_proj_weight", "dt_projs_weight"):
        return _K_T
    if re.fullmatch(r"x_proj_[12]|dt_proj_[12]_weight", leaf):
        return _T
    return _ID


def _torch_key(path: str) -> str:
    rules = _RULES
    if path.startswith("backbone/") and not _SIGMA_BACKBONE.match(path):
        rules = _DUAL_RULES
    for pat, rep in rules:
        path = re.sub(pat, rep, path)
    return path.replace("/", ".")


_STATS = {"mean": "running_mean", "var": "running_var"}


def state_dict_from_jax(params, model: nn.Module | None = None,
                        batch_stats=None):
    """JAX EncoderDecoder params (and, for a BatchNorm decoder, its
    `batch_stats` collection) -> the port's state_dict (fp32 tensors).

    Every JAX leaf maps to exactly one key. With `model`, the keys must
    equal the model's state_dict keys: a port key left unfilled or a JAX
    leaf left unused raises KeyError naming them."""
    out = {}
    for parts, w in _flatten(batch_stats or {}):
        key = _torch_key("/".join(parts[:-1])) + "." + _STATS[parts[-1]]
        out[key] = torch.from_numpy(np.array(w, dtype=np.float32))

    def put(path, w):
        key = _torch_key(path)
        if key in out:
            raise KeyError(f"two JAX leaves map to {key}")
        leaf = path.rsplit("/", 1)[-1]
        out[key] = torch.from_numpy(
            np.array(_transform(path, leaf, w.ndim)(w), dtype=np.float32)
        )

    for parts, w in _flatten(params):
        path = "/".join(parts)
        m = re.search(r"layers_(\d+)_scan/", path)
        if m:  # nn.scan-stacked stage: params stacked on axis 0
            for j in range(w.shape[0]):
                put(path.replace(m.group(0),
                                 f"layers_{m.group(1)}_blocks_{j}/"), w[j])
        else:
            put(path, w)
    if model is not None:
        want = set(model.state_dict())
        unfilled, unused = sorted(want - set(out)), sorted(set(out) - want)
        if unfilled or unused:
            raise KeyError(
                f"port keys not filled: {unfilled[:20]}; JAX leaves not "
                f"used: {unused[:20]}")
    return out


def load_torch_state_dict(path: str) -> dict:
    """{name: tensor} of a .pth/.pt or a torch-named .npz: the tensors of
    the envelope's `model` / `state_dict` / `module` entry, or of the file
    itself, every other entry dropped (trusted input: see above)."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: torch.from_numpy(z[k]) for k in z.files}
    obj = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("model", "state_dict", "module"):
        if isinstance(obj, dict) and key in obj:
            obj = obj[key]
            break
    return {k: v.detach() for k, v in obj.items()
            if isinstance(v, torch.Tensor)}


def _strip(sd):
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in sd.items()}


def _trunk_candidates(key: str) -> list[str]:
    """The released VMamba keys that may fill the trunk key `key` (relative
    to `backbone.vssm`), in the JAX package's order: the released name
    first, then the remapped one, which the port's modules carry."""
    parts = key.split(".")
    if parts[0] == "patch_embed":
        alias = {"0": "proj", "2": "norm"}[parts[1]]
        return [f"patch_embed.{alias}.{parts[2]}", key]
    if parts[0] == "layers" and parts[2] == "blocks":
        base, sub, rest = ".".join(parts[:4]), parts[4], ".".join(parts[5:])
        if sub == "norm":
            return [f"{base}.ln_1.{rest}", key]
        if sub == "op":
            return [f"{base}.self_attention.{rest}", key]
    return [key]


def _classifier_candidates(key: str) -> list[str]:
    """A VSSMClassifier key's candidates: the head's under `classifier.`
    first, then the published name; the trunk's as `_trunk_candidates`."""
    if key.startswith("classifier."):
        return [key, key[len("classifier."):]]
    return _trunk_candidates(key)


def _full_candidates(key: str) -> list[str]:
    trunk = "backbone.vssm."
    if key.startswith(trunk):
        return [trunk + k for k in _trunk_candidates(key[len(trunk):])]
    return [key]


def _ingest(module: nn.Module, sd, candidates):
    """Fill `module`'s tensors from `sd` in place, each from the first of
    its candidate keys that `sd` holds; a shape mismatch raises, a tensor
    with no candidate keeps its value. Returns (loaded sd keys, missing
    module keys)."""
    loaded, missing = [], []
    with torch.no_grad():
        for key, dst in module.state_dict().items():
            src = next((c for c in candidates(key) if c in sd), None)
            if src is None:
                missing.append(key)
                continue
            w = sd[src]
            if tuple(w.shape) != tuple(dst.shape):
                raise ValueError(
                    f"shape mismatch for {key}: ckpt {tuple(w.shape)} "
                    f"({src}) vs model {tuple(dst.shape)}")
            dst.copy_(w)
            loaded.append(src)
    return loaded, missing


def _state_dict(path):
    return _strip(load_torch_state_dict(path) if isinstance(path, str)
                  else path)


def load_vmamba_into_model(model: nn.Module, path):
    """Load a VMamba ImageNet checkpoint (a path, or its state dict) into
    `model.backbone.vssm` in place, or into the whole of a VSSMClassifier
    (strict=False semantics, see above). Returns (loaded, missing,
    unexpected): the checkpoint keys used, the trunk keys left at their
    init, the checkpoint keys dropped."""
    sd = _state_dict(path)
    if isinstance(model, VSSMClassifier):
        loaded, missing = _ingest(model, sd, _classifier_candidates)
    else:
        loaded, missing = _ingest(model.backbone.vssm, sd, _trunk_candidates)
    unexpected = sorted(set(sd) - set(loaded))
    logger = get_logger()
    logger.info(
        "vmamba ingest: %d tensors loaded, %d missing (fresh init), "
        "%d unexpected (dropped, e.g. classifier head)",
        len(loaded), len(missing), len(unexpected))
    if missing:
        logger.debug("missing: %s", missing)
    return loaded, missing, unexpected


def load_checkpoint_into_model(model: nn.Module, path: str):
    """Dispatch of a checkpoint file: a full trained Sigma model (keys
    under `backbone.` / `decode_head.`) over the whole model, anything
    else as a VMamba trunk through `load_vmamba_into_model`. Returns
    (loaded, missing, unexpected)."""
    sd = load_checkpoint(path)
    if not any(k.startswith(("backbone.", "decode_head.")) for k in sd):
        return load_vmamba_into_model(model, sd)
    loaded, missing = _ingest(model, sd, _full_candidates)
    unexpected = sorted(set(sd) - set(loaded))
    logger = get_logger()
    logger.info("sigma full ingest: %d loaded, %d fresh-init, %d unexpected",
                len(loaded), len(missing), len(unexpected))
    if missing:
        logger.warning("missing (fresh init): %s", missing[:20])
    if unexpected:
        logger.debug("unexpected: %s", unexpected[:20])
    return loaded, missing, unexpected


def convert_mit_trunk(trunk: nn.Module, sd):
    """Fill one MiTTrunk in place from a released SegFormer (MiT) state
    dict, whose keys are the trunk's own (`patch_embed{i}.*`,
    `block{i}.{j}.*`, `norm{i}.*`). Returns (loaded sd keys, trunk keys
    left at their init)."""
    return _ingest(trunk, _strip(sd), lambda k: [k])


def load_mit_dualpath(model: nn.Module, path):
    """A released single-trunk MiT file (a path, or its state dict) into
    both trunks of `model.backbone` (a DualMiTEncoder). Returns (loaded,
    missing): the file's keys used (once per trunk) and the trunks' keys
    left at their init."""
    sd = _state_dict(path)
    loaded, missing = [], []
    for name in ("trunk", "extra_trunk"):
        got, fresh = convert_mit_trunk(getattr(model.backbone, name), sd)
        get_logger().info("mit ingest %s: %d loaded, %d fresh", name,
                          len(got), len(fresh))
        loaded += got
        missing += [f"{name}.{k}" for k in fresh]
    return loaded, missing


def _swin_candidates(key: str) -> list[str]:
    """The released single-trunk key of a DualSwinEncoder key: both
    modality paths read the trunk's; FRM, FFM and the out-norms none."""
    for ours, released in (("patch_embed_d.", "patch_embed."),
                           ("layers_d.", "layers."),
                           ("patch_embed.", "patch_embed."),
                           ("layers.", "layers.")):
        if key.startswith(ours):
            return [released + key[len(ours):]]
    return []


def convert_swin_dual(encoder: nn.Module, sd):
    """Fill a DualSwinEncoder in place from a released single-trunk Swin
    state dict, the same weights into both modality paths. Returns
    (loaded sd keys, encoder keys left at their init)."""
    return _ingest(encoder, _strip(sd), _swin_candidates)


def load_swin_dualpath(model: nn.Module, path):
    """A released single-trunk Swin file (a path, or its state dict) into
    both paths of `model.backbone` (a DualSwinEncoder). Returns (loaded,
    missing)."""
    loaded, missing = convert_swin_dual(model.backbone, _state_dict(path))
    get_logger().info("swin dual ingest: %d loaded, %d fresh", len(loaded),
                      len(missing))
    return loaded, missing


def load_checkpoint(path: str):
    """The tensors of a checkpoint file, keyed by torch names: a
    `.pth`/`.pt`, a torch-named `.npz`, or an `.npz` of JAX params under
    `/`-joined flax paths (turned into the port's state_dict)."""
    sd = load_torch_state_dict(path)
    if not any("/" in k for k in sd):
        return _strip(sd)
    tree: dict = {}
    for name, w in sd.items():
        node = tree
        *dirs, leaf = name.split("/")
        for d in dirs:
            node = node.setdefault(d, {})
        node[leaf] = w.numpy()
    return state_dict_from_jax(tree)
