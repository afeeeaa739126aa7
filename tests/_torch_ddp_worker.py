"""One rank of `tests/test_torch_port_ddp.py`'s runs of the train CLI:

  python -m torch.distributed.run --standalone --nproc_per_node=2 \\
      tests/_torch_ddp_worker.py OUT_DIR <train CLI arguments> --distributed

(or `run(OUT_DIR, argv[, with_bn])` in one process). It runs
`sigma_tpu_torch.train.main(argv)` with the train step wrapped to record
the loss each step returns and the gradients the last step left (in a
rank: DDP's all-reduced ones), and, once the process group is up, the
share `segmentation_loss` gives this rank on a fixed global batch whose
second half is all ignored, with its gradient; then (`with_bn`, the
default) one train step of a
seeded sigma_test with UPernet (BatchNorm decoder and FCN aux head) on
this rank's share of a fixed global batch of 6, once as the port takes
it and once with a planted fault (BatchNorm's statistics of the shard
alone), each step's all-reduced gradients and running statistics kept;
it writes OUT_DIR/rank<r>.json and OUT_DIR/grads<r>.pt. Imports torch
and the port only.
"""

import copy
import json
import os
import sys

import numpy as np
import torch

GLOBAL = 4  # rows of the fixed loss batch
# the UPernet step's global batch: with 2, UPerHead's 1x1-pool BatchNorm
# sees two values per channel, and fp32 rounding alone moves the trunk's
# gradients by 4% of their norm (tests/test_torch_port_decoders.py)
BN_GLOBAL = 6


def loss_batch():
    """A fixed (logits, labels) batch of 4 rows; rows 2-3 all ignored."""
    rng = np.random.default_rng(11)
    logits = rng.normal(size=(GLOBAL, 6, 6, 5)).astype(np.float32)
    labels = rng.integers(0, 5, (GLOBAL, 6, 6))
    labels[:, 0] = 255
    labels[2:] = 255
    return logits, labels


def _loss_term(device):
    from sigma_tpu_torch.models.builder import segmentation_loss
    from sigma_tpu_torch.parallel import dist

    logits, labels = loss_batch()
    n = GLOBAL // dist.world()
    rows = slice(dist.rank() * n, (dist.rank() + 1) * n)
    x = torch.tensor(logits[rows], device=device, requires_grad=True)
    term = segmentation_loss(x, torch.tensor(labels[rows], device=device),
                             sharded=dist.data_parallel())
    term.backward()
    return float(term.detach()), x.grad.cpu().numpy().tolist()


def _bn_steps(device):
    """{"global" | "per_shard" (ranks only): ({name: gradient}, {name:
    running statistic})} of one UPernet step (lr 0) on this rank's share
    of a fixed global batch of BN_GLOBAL."""
    from sigma_tpu_torch.configs import get_config
    from sigma_tpu_torch.engine.optim import build_optimizer
    from sigma_tpu_torch.engine.train import (
        create_train_state,
        make_train_step,
    )
    from sigma_tpu_torch.models import norm
    from sigma_tpu_torch.models.builder import EncoderDecoder, init_parameters
    from sigma_tpu_torch.parallel import dist

    rng = np.random.default_rng(12)
    label = rng.integers(0, 9, (BN_GLOBAL, 32, 32))
    label[:, :4] = 255
    batch = {k: rng.normal(size=(BN_GLOBAL, 32, 32, 3)).astype(np.float32)
             for k in ("data", "modal_x")}
    batch["label"] = label
    n = BN_GLOBAL // dist.world()
    rows = slice(dist.rank() * n, (dist.rank() + 1) * n)
    shard = {k: v[rows] for k, v in batch.items()}
    out = {}
    real = norm.all_reduce_sum_autograd
    seeded = init_parameters(EncoderDecoder(9, "sigma_test", "UPernet",
                                            remat=False), seed=13)
    # in one process the shard is the global batch: the fault is no fault
    for case in ("global", "per_shard")[:1 + dist.data_parallel()]:
        model = copy.deepcopy(seeded).to(device)
        opt = build_optimizer(get_config("mfnet"), model)
        step = make_train_step(model, opt, lambda k: 0.0, dropout_seed=14)
        if case == "per_shard":
            norm.all_reduce_sum_autograd = lambda t: t
        try:
            step(create_train_state(model, opt), shard)
        finally:
            norm.all_reduce_sum_autograd = real
        out[case] = ({k: p.grad.detach().cpu().clone()
                      for k, p in model.named_parameters()},
                     {k: b.detach().cpu().clone()
                      for k, b in model.named_buffers()})
    return out


def run(out_dir, argv, with_bn=True):
    from sigma_tpu_torch import train
    from sigma_tpu_torch.engine import train as engine_train
    from sigma_tpu_torch.parallel import dist

    record = {"losses": []}
    build = engine_train.build_train

    grads, bn_steps = {}, {}

    def recording_build(cfg, device="cuda"):
        state, step, schedule = build(cfg, device)
        record.update(rank=dist.rank(), world=dist.world())
        record["term"], record["grad"] = _loss_term(device)
        if with_bn:
            bn_steps.update(_bn_steps(device))

        def recording_step(state, batch):
            loss = step(state, batch)
            record["losses"].append(float(loss))
            grads.update((k, p.grad.detach().clone()) for k, p in
                         state.model.named_parameters() if p.grad is not None)
            return loss

        return state, recording_step, schedule

    engine_train.build_train = recording_build
    try:
        assert train.main(argv) == 0
    finally:
        engine_train.build_train = build
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"rank{record['rank']}.json"), "w") as f:
        json.dump(record, f)
    torch.save(dict(grads, bn_steps=bn_steps),
               os.path.join(out_dir, f"grads{record['rank']}.pt"))
    return dict(record, grads=grads, bn_steps=bn_steps)


if __name__ == "__main__":
    torch.set_num_threads(1)
    run(sys.argv[1], sys.argv[2:])
