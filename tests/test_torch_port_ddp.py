"""Data-parallel training of the port (`--distributed`) on the CPU: two
gloo ranks under torchrun against one process with the same global batch.

  * the train CLI's main under `python -m torch.distributed.run
    --nproc_per_node=2 ... --distributed --device cpu`
    (tests/_torch_ddp_worker.py) on a synthetic PNG tree: sigma_test at
    its drop-path rate (0.1), global batch 4 (2 a rank), 2 steps at lr
    1e-4 with no warmup (so that each update moves the weights by about
    1e-4, ten times the bound below, and the second step's loss sees the
    first; at 1e-3 AdamW's eps of 1e-8 turns the sum-order noise of a
    near-zero gradient into weight differences of about 1.2e-5), one epoch's
    evaluation (3 val images: 2 on rank 0, 1 on rank 1) and checkpoint;
    and the same CLI in one process. The losses and the post-update
    weights agree within max 1e-5 (the ranks' gradients are summed in
    another order), the last step's all-reduced gradient within 1e-5 of
    the one-process gradient's norm, the mIoU exactly.
  * the run wrote one checkpoint (rank 0's), which `-c` resumes in one
    process as the one-process run's resumes, and which the eval CLI
    scores to the train-time mIoU exactly (the whole set in one process
    against the sharded, all-reduced evaluation).
  * the loss shares of the two ranks on a batch whose second shard is all
    ignored: they sum to JAX's `segmentation_loss` on the global batch,
    the ignored rank's is 0, and their gradients are JAX's gradient of it.
  * global-batch BatchNorm: a sigma_test UPernet step in the same ranks
    (three samples each) against one process at batch 6, the all-reduced
    gradient within 1e-5 of its norm and both ranks' new running
    statistics within 1e-5; a planted fault (each rank's statistics of
    its own shard) fails that check.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigma_tpu.models.builder import segmentation_loss as jax_loss
from sigma_tpu_torch.data.png import write_png

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("_torch_ddp_worker.py")
sys.path.insert(0, str(WORKER.parent))
import _torch_ddp_worker as worker  # noqa: E402

TORCH_THREADS = 2
TOL = 1e-5
GRAD_TOL = 1e-5  # relative to the one-process gradient's norm


def _tree(root):
    """MFNet layout: 4 train, 3 val images of 40x56."""
    for sub in ("RGB", "Label", "Modal"):
        (root / sub).mkdir(parents=True)
    rng = np.random.default_rng(3)
    names = [f"p{i}" for i in range(7)]
    for n in names:
        write_png(root / "RGB" / f"{n}.png",
                  rng.integers(0, 255, (40, 56, 3), dtype=np.uint8))
        label = rng.integers(0, 9, (40, 56)).astype(np.uint8)
        label[:5] = 255
        write_png(root / "Label" / f"{n}.png", label)
        write_png(root / "Modal" / f"{n}.png",
                  rng.integers(0, 255, (40, 56), dtype=np.uint8))
    (root / "train2.txt").write_text("\n".join(names[:4]) + "\n")
    (root / "test.txt").write_text("\n".join(names[4:]) + "\n")


def _argv(tree, log):
    return ["-n", "mfnet", "--dataset-path", str(tree), "--device", "cpu",
            "--backbone", "sigma_test", "--batch-size", "4", "--steps", "2",
            "--lr", "1e-4", "--override", "warm_up_epoch=0",
            "--log-dir", str(log), "--override", "num_train_imgs=4",
            "--override", "image_height=32", "--override", "image_width=32",
            "--override", "eval_crop_size=(32,32)",
            "--override", "num_workers=1"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two-rank run (subprocesses) and the one-process run (here)."""
    base = tmp_path_factory.mktemp("ddp")
    tree = base / "tree"
    _tree(tree)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", str(WORKER), str(base / "ddp_out"),
         *_argv(tree, base / "ddp"), "--distributed"],
        env=env, cwd=str(base), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    ranks = [json.loads((base / "ddp_out" / f"rank{r}.json").read_text())
             for r in range(2)]
    grads = torch.load(base / "ddp_out" / "grads0.pt", weights_only=True)
    bn_ranks = [grads.pop("bn_steps"), torch.load(
        base / "ddp_out" / "grads1.pt", weights_only=True)["bn_steps"]]
    threads = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    try:
        one = worker.run(str(base / "one_out"), _argv(tree, base / "one"))
    finally:
        torch.set_num_threads(threads)
    return dict(base=base, tree=tree, ranks=ranks, grads=grads, one=one,
                ddp=base / "ddp", single=base / "one", log=proc.stderr,
                bn_ranks=bn_ranks)


def _weights(log):
    return torch.load(log / "checkpoint" / "epoch-1" / "model.pt",
                      weights_only=True)


def _scores(log):
    return json.loads((log / "checkpoint" / "val_scores.json").read_text())


def test_two_ranks_equal_one_process(runs):
    r0, r1, one = *runs["ranks"], runs["one"]
    assert [r0["rank"], r1["rank"], r0["world"], one["world"]] == [0, 1, 2, 1]
    assert len(one["losses"]) == 2
    np.testing.assert_allclose(r0["losses"], one["losses"], rtol=0, atol=TOL)
    assert r0["losses"] == r1["losses"]  # both report the global loss
    ddp, single = _weights(runs["ddp"]), _weights(runs["single"])
    assert set(ddp) == set(single)
    assert all(not k.startswith("module.") for k in ddp)
    worst = max(float((ddp[k] - single[k]).abs().max()) for k in ddp)
    assert worst <= TOL, worst
    # DDP's all-reduced gradient of the last step is one process's
    got, want = runs["grads"], one["grads"]
    assert set(got) == set(want)
    diff = sum(float((got[k] - want[k]).double().pow(2).sum()) for k in got)
    norm = sum(float(want[k].double().pow(2).sum()) for k in want)
    assert (diff / norm) ** 0.5 <= GRAD_TOL, (diff / norm) ** 0.5
    (m_ddp, e_ddp), = _scores(runs["ddp"])
    (m_one, e_one), = _scores(runs["single"])
    assert e_ddp == e_one == 1 and m_ddp == m_one


def _bn_gaps(rank_steps, one_step):
    """(the all-reduced gradient's distance from one process's, relative
    to its norm; the largest running-statistic difference over both
    ranks) of one UPernet step."""
    (grads, _), (want_g, want_s) = rank_steps[0], one_step
    diff = sum(float((grads[k] - want_g[k]).double().pow(2).sum())
               for k in want_g)
    norm = sum(float(want_g[k].double().pow(2).sum()) for k in want_g)
    stats = max(float((s[k] - want_s[k]).abs().max())
                for _, s in rank_steps for k in want_s)
    return (diff / norm) ** 0.5, stats


def test_batchnorm_statistics_are_the_global_batchs(runs):
    """UPernet (BatchNorm in every ConvBNReLU, UPerHead's 1x1 pool at
    three values a channel on each rank): two ranks' step gives one
    process's all-reduced
    gradient (within GRAD_TOL of its norm) and, on both ranks, its new
    running statistics (within TOL); the step with a planted fault, each
    rank's statistics of its own shard, fails that check."""
    one = runs["one"]["bn_steps"]["global"]
    assert len(one[1]) == 26  # 13 BatchNorms, mean and var each
    gaps = {case: _bn_gaps([r[case] for r in runs["bn_ranks"]], one)
            for case in ("global", "per_shard")}
    print(f"BatchNorm under two ranks (gradient, statistics): {gaps}")
    assert gaps["global"][0] <= GRAD_TOL and gaps["global"][1] <= TOL
    assert gaps["per_shard"][0] > GRAD_TOL and gaps["per_shard"][1] > TOL


def test_one_checkpoint_resumes_and_evaluates_in_one_process(
        runs, monkeypatch):
    from sigma_tpu_torch import eval as eval_cli
    from sigma_tpu_torch.engine.evaluator import SlidingEvaluator

    ckpt = runs["ddp"] / "checkpoint"
    assert sorted(os.listdir(ckpt)) == ["epoch-1", "epoch-last",
                                        "val_scores.json"]
    assert (ckpt / "epoch-last").read_text() == "1"
    # (tb: tensorboard's, where tensorboardX is installed)
    assert sorted(set(os.listdir(runs["ddp"])) - {"tb"}) == [
        "checkpoint", "val_epoch_1.log", "val_last.log"]
    # -c in one process, from the two-rank run and from the one-process
    # run: the same next step
    resumed = []
    threads = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    try:
        for i, log in enumerate((runs["ddp"], runs["single"])):
            argv = _argv(runs["tree"], log)
            argv[argv.index("--steps") + 1] = "1"
            rec = worker.run(str(runs["base"] / f"resumed{i}"),
                             [*argv, "-c", "--no-eval"], with_bn=False)
            resumed.append(rec["losses"])
            meta = json.loads((log / "checkpoint" / "epoch-2" /
                               "meta.json").read_text())
            assert meta == {"epoch": 2, "step": 3}
        # the eval CLI on the two-rank checkpoint, the whole set here
        scores = []
        run = SlidingEvaluator.run

        def recording_run(self, *a, **k):
            out = run(self, *a, **k)
            scores.append(out[0])
            return out

        monkeypatch.setattr(SlidingEvaluator, "run", recording_run)
        assert eval_cli.main(["-n", "mfnet", "--dataset-path",
                              str(runs["tree"]), "--device", "cpu",
                              "--backbone", "sigma_test", "--log-dir",
                              str(runs["ddp"]), "-e", "1", "--override",
                              "eval_crop_size=(32,32)"]) == 0
    finally:
        torch.set_num_threads(threads)
    assert len(resumed[0]) == 1
    np.testing.assert_allclose(resumed[0], resumed[1], rtol=0, atol=TOL)
    (m_ddp, _), = _scores(runs["ddp"])[:1]
    assert scores == [m_ddp]


def test_loss_terms_sum_to_jax_loss_on_the_global_batch(runs):
    r0, r1 = runs["ranks"]
    logits, labels = worker.loss_batch()
    want, grad = jax.value_and_grad(jax_loss)(jnp.asarray(logits),
                                              jnp.asarray(labels))
    assert r1["term"] == 0.0  # its shard is all ignored
    np.testing.assert_allclose(r0["term"] + r1["term"], float(want),
                               rtol=1e-6)
    got = np.concatenate([r0["grad"], r1["grad"]])
    np.testing.assert_allclose(got, np.asarray(grad), rtol=1e-5, atol=1e-8)
    # one process: the plain mean
    np.testing.assert_allclose(runs["one"]["term"], float(want), rtol=1e-6)
