"""Checkpoint and resume, in the JAX package's file format.

Counterpart of ``collaborative_gan_sampling_tpu/utils/checkpoint.py``.
Collaborative sampling is a phase that runs after training, on a restored
checkpoint: train once, then refine many times with different (K, lambda,
gamma).

A checkpoint is the JAX package's ``TrainState`` as Flax writes it
(``flax.serialization.msgpack_serialize``, here through the port's own
codec, ``utils/msgpack.py``), with params, statistics and Adam moments in
Flax layouts (``utils/weights.py``)::

    {'g_vars': {'params', ['batch_stats']}, 'd_vars': {...},
     'g_opt': {'0': {'count', 'mu', 'nu'}, '1': {}}, 'd_opt': {...},
     'step': int32 0-d array, 'g_ema': params tree or None}

so a checkpoint that either package writes restores in the other. Files are
written atomically (a temporary file, then a rename) as
``ckpt_{step:08d}.msgpack``; ``config.json`` beside them holds the config
and its content hash, and a restore with a config whose model section
differs raises ``ConfigMismatchError`` naming the fields. No random state
is saved: every draw is keyed by (seed, step, role) (``utils/prng.py``).
"""

from __future__ import annotations

import copy
import hashlib
import json
import os
from typing import Any

import numpy as np

from collaborative_gan_sampling_torch.utils import msgpack
from collaborative_gan_sampling_torch.utils.weights import (
    adam_to_optax,
    load_jax_params,
    load_jax_variables,
    load_optax_adam,
    params_to_flax,
    to_jax_variables,
)


class ConfigMismatchError(ValueError):
    """Restoring a checkpoint whose saved config disagrees with the
    caller's (otherwise an opaque shape error deep in the restore)."""


def _ckpt_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"ckpt_{step:08d}.msgpack")


def _config_dict(config: Any) -> dict:
    return config if isinstance(config, dict) else config.to_dict()


def _config_hash(cfg_dict: dict) -> str:
    blob = json.dumps(cfg_dict, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def state_dict(state) -> dict:
    """A ``training.gan.TrainState`` as the JAX package's state dict."""
    return {
        "g_vars": to_jax_variables(state.g),
        "d_vars": to_jax_variables(state.d),
        "g_opt": adam_to_optax(state.g_opt, state.g),
        "d_opt": adam_to_optax(state.d_opt, state.d),
        "step": np.asarray(state.step, np.int32),
        "g_ema": (None if state.g_ema is None
                  else params_to_flax(state.g_ema)),
    }


def load_state_dict(state, raw: dict):
    """Load a state dict (``state_dict``'s layout) into ``state`` in place
    and return it. A checkpoint without ``g_ema`` restores into a state
    that tracks none; one with ``g_ema`` gives the state an EMA generator,
    as the JAX package's restore does."""
    missing = [k for k in ("g_vars", "d_vars", "g_opt", "d_opt", "step")
               if k not in raw]
    if missing or ("g_ema" not in raw and state.g_ema is not None):
        raise KeyError(f"checkpoint lacks {missing or ['g_ema']}")
    load_jax_variables(state.g, raw["g_vars"])
    load_jax_variables(state.d, raw["d_vars"])
    load_optax_adam(state.g_opt, state.g, raw["g_opt"])
    load_optax_adam(state.d_opt, state.d, raw["d_opt"])
    state.step = int(np.asarray(raw["step"]))
    ema = raw.get("g_ema")
    if ema is None:
        state.g_ema = None
    else:
        if state.g_ema is None:
            state.g_ema = copy.deepcopy(state.g)
        load_jax_params(state.g_ema, ema)
    return state


def save_checkpoint(ckpt_dir: str, step: int, state: Any, keep: int = 3,
                    config: Any | None = None) -> str:
    """Atomically write ``state`` (a TrainState, or a state dict) for
    ``step`` and prune all but the ``keep`` newest checkpoints. With
    ``config`` (a Config or a plain dict), also the ``config.json``
    sidecar with its content hash."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tree = state if isinstance(state, dict) else state_dict(state)
    path = _ckpt_path(ckpt_dir, step)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(msgpack.packb(tree))
    os.replace(tmp, path)  # atomic on POSIX
    if config is not None:
        cfg = _config_dict(config)
        side = os.path.join(ckpt_dir, "config.json")
        tmp = side + ".tmp"
        with open(tmp, "w") as fh:
            json.dump({"config": cfg, "hash": _config_hash(cfg)}, fh,
                      indent=2, sort_keys=True)
        os.replace(tmp, side)
    _prune(ckpt_dir, keep)
    return path


def _ckpts(ckpt_dir: str) -> list[str]:
    return sorted(f for f in os.listdir(ckpt_dir)
                  if f.startswith("ckpt_") and f.endswith(".msgpack"))


def latest_checkpoint(ckpt_dir: str) -> str | None:
    if not os.path.isdir(ckpt_dir):
        return None
    ckpts = _ckpts(ckpt_dir)
    return os.path.join(ckpt_dir, ckpts[-1]) if ckpts else None


def restore_checkpoint(path: str, target: Any | None = None,
                       config: Any | None = None) -> Any:
    """The raw state dict at ``path``, or, with ``target`` (a TrainState),
    the checkpoint loaded into it. With ``config``, the directory's
    ``config.json`` (if there) must agree with it on the model section."""
    if config is not None:
        _check_config(os.path.dirname(os.path.abspath(path)), config)
    with open(path, "rb") as fh:
        raw = msgpack.unpackb(fh.read())
    return raw if target is None else load_state_dict(target, raw)


def saved_config(ckpt_dir: str) -> dict | None:
    """The config dict stored beside the checkpoints, or None. Its content
    hash is verified: an edited or corrupted sidecar fails loudly."""
    side = os.path.join(ckpt_dir, "config.json")
    if not os.path.exists(side):
        return None
    with open(side) as fh:
        data = json.load(fh)
    cfg = data["config"]
    want = data.get("hash")
    if want is not None and _config_hash(cfg) != want:
        raise ConfigMismatchError(
            f"{side} is corrupted or was edited by hand (content hash "
            f"mismatch); delete it or restore the original sidecar")
    return cfg


def _check_config(ckpt_dir: str, config: Any) -> None:
    saved = saved_config(ckpt_dir)
    if saved is None:
        return
    current = _config_dict(config)
    saved_model = saved.get("model", saved)
    cur_model = current.get("model", current)
    diffs = sorted(k for k in set(saved_model) | set(cur_model)
                   if saved_model.get(k) != cur_model.get(k))
    if diffs:
        detail = ", ".join(
            f"{k}: saved={saved_model.get(k)!r} vs "
            f"current={cur_model.get(k)!r}" for k in diffs)
        raise ConfigMismatchError(
            f"checkpoint in {ckpt_dir} was written with a different model "
            f"config ({detail}); restore with the matching config or delete "
            f"the checkpoint dir")


def _prune(ckpt_dir: str, keep: int) -> None:
    for f in _ckpts(ckpt_dir)[:-keep] if keep > 0 else []:
        os.remove(os.path.join(ckpt_dir, f))
