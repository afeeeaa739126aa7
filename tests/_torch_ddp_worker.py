"""One rank of `tests/test_torch_port_ddp.py`'s runs of the train CLI:

  python -m torch.distributed.run --standalone --nproc_per_node=2 \\
      tests/_torch_ddp_worker.py OUT_DIR <train CLI arguments> --distributed

(or `run(OUT_DIR, argv)` in one process). It runs
`sigma_tpu_torch.train.main(argv)` with the train step wrapped to record
the loss each step returns and the gradients the last step left (in a
rank: DDP's all-reduced ones), and, once the process group is up, the
share `segmentation_loss` gives this rank on a fixed global batch whose
second half is all ignored, with its gradient; it writes
OUT_DIR/rank<r>.json and OUT_DIR/grads<r>.pt. Imports torch and the port
only.
"""

import json
import os
import sys

import numpy as np
import torch

GLOBAL = 4  # rows of the fixed loss batch


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


def run(out_dir, argv):
    from sigma_tpu_torch import train
    from sigma_tpu_torch.engine import train as engine_train
    from sigma_tpu_torch.parallel import dist

    record = {"losses": []}
    build = engine_train.build_train

    grads = {}

    def recording_build(cfg, device="cuda"):
        state, step, schedule = build(cfg, device)
        record.update(rank=dist.rank(), world=dist.world())
        record["term"], record["grad"] = _loss_term(device)

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
    torch.save(grads, os.path.join(out_dir, f"grads{record['rank']}.pt"))
    return dict(record, grads=grads)


if __name__ == "__main__":
    torch.set_num_threads(1)
    run(sys.argv[1], sys.argv[2:])
