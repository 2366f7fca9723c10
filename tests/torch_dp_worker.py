"""One rank of the port's two-process data-parallel run on the CPU
(tests/test_torch_parallel.py; the counterpart of
tests/multihost_worker.py).

Run as: python torch_dp_worker.py <rank> <world> <port> <workdir> <out>

Rank 0 joins the gloo group through `initialize_distributed`'s
arguments, the other ranks through torchrun's variables (MASTER_ADDR,
MASTER_PORT, WORLD_SIZE, RANK). Each trains `dp_config()` for 3 steps
on its stride of `dp_frames()` and saves its final parameters, EMA and
step to <out>/rank<rank>.pt.
"""

import dataclasses
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from dcf_torch.config import tiny_config  # noqa: E402
from dcf_torch.data.synthetic import make_frame  # noqa: E402

STEPS = 3


def dp_config(batch_size: int):
    """tiny_config in float32 with EMA and without augmentation, so
    batches depend on the frames alone: a per-process batch of 1 over two
    processes and a single-process batch of 2 see the same examples."""
    cfg = tiny_config(True)
    return dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, dtype="float32"),
        augment=dataclasses.replace(cfg.augment, flip_prob=0.0,
                                    gt_sampling=False, global_rotation=0.0,
                                    global_scale=(1.0, 1.0)),
        train=dataclasses.replace(cfg.train, batch_size=batch_size,
                                  num_steps=STEPS, ema_decay=0.5,
                                  checkpoint_every=1000, log_every=1))


def dp_frames():
    """Two frames with 3 and 1 boxes, small enough (1,500 and 1,300
    points) that crop_and_pad never subsamples them, whatever its seed."""
    return [make_frame("000000", n_ground=1200, pts_per_box=100, seed=0),
            make_frame("000001", boxes=[("Car", 12.0, -3.0, 0.5)],
                       n_ground=1200, pts_per_box=100, seed=1)]


class Frames:
    def __init__(self, frames):
        self.frames = frames

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i):
        return self.frames[i]


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    port, workdir, out = sys.argv[3], sys.argv[4], sys.argv[5]
    torch.set_num_threads(1)
    import torch.distributed as dist
    from dcf_torch.parallel import mesh
    from dcf_torch.train.loop import train
    if rank == 0:
        joined = mesh.initialize_distributed(f"localhost:{port}", world, 0,
                                             backend="gloo")
    else:
        os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=port,
                          WORLD_SIZE=str(world), RANK=str(rank))
        joined = mesh.initialize_distributed()
    assert joined and mesh.process_count() == world
    assert dist.get_backend() == "gloo"
    state = train(dp_config(1), Frames(dp_frames()), workdir, device="cpu",
                  num_steps=STEPS, num_data_shards=world)
    torch.save({"step": state.step,
                "params": {n: p.detach() for n, p in
                           state.model.named_parameters()},
                "ema": state.ema},
               os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()
    print(f"rank {rank} done", flush=True)


if __name__ == "__main__":
    main()
