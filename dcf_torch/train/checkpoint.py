"""Atomic checkpoint save / restore of a `TrainState`, mirroring
`dcf.train.checkpoint`.

A checkpoint is one `torch.save` file, `ckpt_<step>.pt`: the step, the
parameters, the optimizer's state, the EMA and the generator's state.
It is written to a temp file and renamed, so a crash mid-save never
corrupts the latest checkpoint; `config.json` is written once beside
them; the newest `keep` are kept.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from dcf_torch.config import Config
from dcf_torch.train.state import TrainState

_PREFIX, _SUFFIX = "ckpt_", ".pt"


def _host(tree):
    """Tensors of a nested dict / list moved to the CPU, detached."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host(v) for v in tree]
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    return tree


def save_checkpoint(ckpt_dir: str, state: TrainState, cfg: Config,
                    keep: int = 5) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = _host({"step": state.step,
                     "params": state.model.state_dict(),
                     "optimizer": state.optimizer.state_dict(),
                     "ema": state.ema,
                     "generator": state.generator.get_state()})
    path = os.path.join(ckpt_dir, f"{_PREFIX}{state.step:08d}{_SUFFIX}")
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    cfg_path = os.path.join(ckpt_dir, "config.json")
    if not os.path.exists(cfg_path):
        tmp = cfg_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(cfg.to_json())
        os.replace(tmp, cfg_path)
    _prune(ckpt_dir, keep)
    return path


def _checkpoints(ckpt_dir: str):
    return sorted(f for f in os.listdir(ckpt_dir)
                  if f.startswith(_PREFIX) and f.endswith(_SUFFIX))


def _prune(ckpt_dir: str, keep: int) -> None:
    for f in _checkpoints(ckpt_dir)[:-keep]:
        os.remove(os.path.join(ckpt_dir, f))


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    ckpts = _checkpoints(ckpt_dir)
    return os.path.join(ckpt_dir, ckpts[-1]) if ckpts else None


@torch.no_grad()
def restore_checkpoint(path: str, template: TrainState) -> TrainState:
    """Restore into a state template (`create_train_state`), in place;
    returns it. A checkpoint saved without EMA, restored into a template
    with EMA on, seeds the EMA from the restored parameters; one saved
    with EMA, restored with EMA off, drops it."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    template.model.load_state_dict(sd["params"])
    template.optimizer.load_state_dict(sd["optimizer"])
    template.generator.set_state(sd["generator"])
    if template.ema is not None:
        src = sd["ema"] if sd["ema"] is not None else {
            n: p for n, p in template.model.named_parameters()}
        for name, e in template.ema.items():
            e.copy_(src[name])
    template.step = int(sd["step"])
    return template


def load_config(ckpt_dir: str) -> Config:
    with open(os.path.join(ckpt_dir, "config.json")) as f:
        return Config.from_json(f.read())
