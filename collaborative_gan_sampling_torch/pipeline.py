"""Experiment orchestration: config -> data -> models -> train -> sample.

Counterpart of ``collaborative_gan_sampling_tpu/pipeline.py`` at its
training and sampling phases:

* ``train``: GAN training in chunks, with resume from the latest
  checkpoint, a tail chunk that stops at ``niters``, a JSONL log and
  periodic checkpoints (the JAX package's file format, so checkpoints
  cross between the two packages);
* ``load_state`` / ``load_or_train``: the sampling phases' entry;
* ``sample`` (the five strategies) and ``generate`` (the serving sampler),
  both with the EMA generator when it is tracked;
* ``save_shaped_d`` / ``load_shaped_d``: the shaped D of a collab run, in
  the same format.

FID, sweeps, tuning, export and the figures are not ported yet; they raise
``NotImplementedError``. Everything runs on the card unless ``device``
says otherwise.
"""

from __future__ import annotations

import copy
import os
import time

import numpy as np
import torch

from collaborative_gan_sampling_torch.config import Config
from collaborative_gan_sampling_torch.data.images import load_image_dataset
from collaborative_gan_sampling_torch.data.synthetic2d import (
    make_mixture,
    sample_mixture,
)
from collaborative_gan_sampling_torch.evals.metrics2d import metrics_2d
from collaborative_gan_sampling_torch.models import make_bundle
from collaborative_gan_sampling_torch.sampling.collab import (
    SampleResult,
    sample,
)
from collaborative_gan_sampling_torch.sampling.serve import ServingSampler
from collaborative_gan_sampling_torch.training.gan import (
    TrainState,
    create_train_state,
    make_train_chunk,
    sampling_g,
)
from collaborative_gan_sampling_torch.utils import msgpack
from collaborative_gan_sampling_torch.utils.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from collaborative_gan_sampling_torch.utils.logging import MetricsWriter
from collaborative_gan_sampling_torch.utils.prng import step_generator
from collaborative_gan_sampling_torch.utils.weights import (
    load_jax_variables,
    to_jax_variables,
)

# The JAX Experiment's methods that the port does not have yet.
_NOT_PORTED = ("adopt_eval_caches", "benchmark", "export", "fid_of_samples",
               "fid_refine", "intra_fid", "kid", "precision_recall",
               "profile", "real_stats", "select_hparams", "select_k", "sweep",
               "teaser")


def shaped_d_path(workdir: str) -> str:
    """Where a workdir's persisted shaped discriminator lives."""
    return os.path.join(workdir, "shaped_d.msgpack")


class Experiment:
    def __init__(self, cfg: Config, echo_metrics: bool = True,
                 device: str | torch.device | None = None):
        self.cfg = cfg.validate()
        self.bundle = make_bundle(cfg.model, device)
        self.device = self.bundle.device
        self.seed = cfg.seed
        self.workdir = cfg.workdir
        self.ckpt_dir = os.path.join(cfg.workdir, "ckpts")
        self._echo = echo_metrics

        self.is_2d = cfg.model.kind == "mlp"
        if self.is_2d:
            self.spec = make_mixture(cfg.data.dataset, cfg.data.ring_radius,
                                     cfg.data.mixture_std, device=self.device)

            def data_fn(generator, n):
                return sample_mixture(generator, self.spec, n), None
        else:
            self.dataset = load_image_dataset(
                cfg.data, image_size=cfg.model.image_size, device=self.device)

            def data_fn(generator, n):  # unconditional models only
                return self.dataset.batch(generator, n)[0], None

        self.data_fn = data_fn

    def __getattr__(self, name):
        if name in _NOT_PORTED:
            raise NotImplementedError(
                f"Experiment.{name} is not ported to PyTorch yet")
        raise AttributeError(name)

    # -- training -----------------------------------------------------------

    def train(self, niters: int | None = None, resume: bool = True,
              state: TrainState | None = None) -> TrainState:
        """Train to ``niters`` (default ``train.niters``) iterations, from
        the latest checkpoint when ``resume``. A log line goes to
        ``train.jsonl`` every ``log_every`` iterations (and at the end) with
        the chunk's mean metrics and the iterations per second since the
        previous line; checkpoints every ``ckpt_every`` and at the end."""
        cfg = self.cfg
        if cfg.train.tensorboard:
            raise NotImplementedError("TensorBoard mirroring is not ported")
        if cfg.train.viz_every:
            raise NotImplementedError("training figures are not ported yet")
        niters = niters if niters is not None else cfg.train.niters
        if state is None:
            state = create_train_state(self.bundle, cfg.train, self.seed)
            if resume:
                path = latest_checkpoint(self.ckpt_dir)
                if path:
                    state = restore_checkpoint(path, target=state,
                                               config=cfg)
        spc = cfg.train.steps_per_call
        chunk = make_train_chunk(self.bundle, cfg.train, self.data_fn,
                                 self.seed)
        # From-scratch runs truncate the log; resumes append to it.
        writer = MetricsWriter(os.path.join(self.workdir, "train.jsonl"),
                               echo=self._echo, append=state.step > 0)
        tail_chunk = None
        t_last, step_last = time.perf_counter(), state.step
        try:
            while state.step < niters:
                remaining = niters - state.step
                if remaining < spc:  # the tail chunk stops at niters
                    if tail_chunk is None:
                        tail_chunk = make_train_chunk(
                            self.bundle, cfg.train, self.data_fn, self.seed,
                            steps_per_call=remaining)
                    state, metrics = tail_chunk(state)
                else:
                    state, metrics = chunk(state)
                step = state.step
                if (step % max(spc, cfg.train.log_every) < spc
                        or step >= niters):
                    # Reading the metrics waits for the chunk's work.
                    metrics = {k: float(v) for k, v in metrics.items()}
                    now = time.perf_counter()
                    writer.write(step, phase="train",
                                 iters_per_s=round((step - step_last)
                                                   / (now - t_last), 2),
                                 **metrics)
                    t_last, step_last = now, step
                if cfg.train.ckpt_every and (
                        step % cfg.train.ckpt_every < spc or step >= niters):
                    save_checkpoint(self.ckpt_dir, step, state, config=cfg)
        finally:
            writer.close()
        return state

    def load_state(self) -> TrainState:
        """Restore the latest training checkpoint (the sampling phases'
        entry condition)."""
        path = latest_checkpoint(self.ckpt_dir)
        if path is None:
            raise FileNotFoundError(
                f"no checkpoint under {self.ckpt_dir}; run train first")
        state = create_train_state(self.bundle, self.cfg.train, self.seed)
        return restore_checkpoint(path, target=state, config=self.cfg)

    def load_or_train(self, niters: int | None = None) -> TrainState:
        """Trained state at the configured iteration count: the latest
        checkpoint, with training resumed if it is behind ``niters``
        (default ``train.niters``)."""
        target = niters if niters is not None else self.cfg.train.niters
        try:
            state = self.load_state()
        except FileNotFoundError:
            return self.train(niters=niters)
        if state.step < target:
            print(f"[load_or_train] checkpoint at step {state.step} < "
                  f"niters {target}; resuming training", flush=True)
            return self.train(niters=niters)
        return state

    # -- sampling -----------------------------------------------------------

    def sample(self, state: TrainState, method: str | None = None,
               generator: torch.Generator | None = None,
               use_shaped_d: bool = False, refine_cfg=None) -> SampleResult:
        """Run a sampling strategy on the trained state (the EMA generator
        when tracked). With ``use_shaped_d``, under the shaped D that
        ``save_shaped_d`` persisted; ``refine_cfg`` overrides
        ``cfg.refine``."""
        gen = generator or step_generator(self.seed, 0, "eval", self.device)
        d = (self.load_shaped_d(template=state.d) if use_shaped_d
             else state.d)
        return sample(self.bundle, sampling_g(state), d,
                      refine_cfg or self.cfg.refine, gen, method=method,
                      data_fn=self.data_fn)

    def generate(self, state: TrainState, n: int, method: str | None = None,
                 use_shaped_d: bool = False,
                 generator: torch.Generator | None = None,
                 out: str | None = None):
        """Serving: at least ``n`` accepted samples through
        ``ServingSampler``. collab serves under a shaped D: the persisted
        one, or else one collab pass shapes D first (drawing from the same
        generator) and persists it. Returns (samples, labels, stats); with
        ``out``, also writes the samples to an .npz."""
        method = method or self.cfg.refine.method
        gen = generator or step_generator(self.seed, 9, "eval", self.device)
        d = state.d
        if method == "collab" and not (use_shaped_d
                                       or os.path.exists(shaped_d_path(
                                           self.workdir))):
            res = self.sample(state, method="collab", generator=gen)
            self.save_shaped_d(res)
            d = res.aux["shaped_d"]
        elif method == "collab" or use_shaped_d:
            d = self.load_shaped_d(template=state.d)
        srv = ServingSampler(self.bundle, self.cfg.refine, method=method)
        samples, labels, stats = srv.generate(sampling_g(state), d, gen, n)
        if out:
            np.savez(out, samples=samples.cpu().numpy())
            stats["out"] = out
        return samples, labels, stats

    # -- shaped-D persistence -----------------------------------------------

    def save_shaped_d(self, result: SampleResult) -> str:
        """Persist the shaped D of a collab run (Flax variables, msgpack),
        so later runs refine under it without shaping again."""
        shaped = result.aux.get("shaped_d")
        if shaped is None:
            raise ValueError("result has no shaped_d (only collab sampling "
                             "shapes D)")
        path = shaped_d_path(self.workdir)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(msgpack.packb(to_jax_variables(shaped)))
        os.replace(tmp, path)
        return path

    def load_shaped_d(self, template: torch.nn.Module) -> torch.nn.Module:
        """The persisted shaped D, in a copy of ``template``."""
        path = shaped_d_path(self.workdir)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no shaped discriminator at {path}; run collab sampling "
                "and save_shaped_d first")
        with open(path, "rb") as fh:
            raw = msgpack.unpackb(fh.read())
        return load_jax_variables(copy.deepcopy(template), raw).eval()

    # -- evaluation ---------------------------------------------------------

    def evaluate(self, result: SampleResult) -> dict[str, float]:
        if not self.is_2d:
            raise NotImplementedError("FID is not ported to PyTorch yet")
        return self.evaluate_2d(result)

    def evaluate_2d(self, result: SampleResult) -> dict[str, float]:
        m = metrics_2d(result.samples, self.spec,
                       hq_std=self.cfg.eval.hq_std,
                       weights=result.accepted.float())
        out = {k: float(v) for k, v in m.items()}
        out["accept_rate"] = result.accept_rate
        return out
