"""Experiment orchestration: config -> data -> models -> train -> sample.

Counterpart of ``collaborative_gan_sampling_tpu/pipeline.py`` at its
training and sampling phases:

* ``train``: GAN training in chunks, with resume from the latest
  checkpoint, a tail chunk that stops at ``niters``, a JSONL log and
  periodic checkpoints (the JAX package's file format, so checkpoints
  cross between the two packages);
* ``load_state`` / ``load_or_train``: the sampling phases' entry;
* ``sample`` (the five strategies; a conditional model's collab shapes
  on real batches of the refined batch's classes) and ``generate`` (the
  serving sampler, optionally of one ``class_id``), both with the EMA
  generator when it is tracked;
* ``save_shaped_d`` / ``load_shaped_d``: the shaped D of a collab run, in
  the same format;
* evaluation: ``evaluate`` (the 2D metrics, or for images FID with KID and
  precision/recall when configured), ``real_stats`` (cached in the process
  and, with ``eval.real_stats_path``, in an npz), ``fid_of_samples``,
  ``kid``, ``precision_recall``, ``intra_fid`` (per-class FID of a
  conditional model's pool), ``fid_refine`` (FID-backprop refinement),
  ``sweep`` / ``select_k`` over the refinement depth, and
  ``adopt_eval_caches``. The feature net is ``eval.feature_net``; "auto"
  trains a classifier on labelled image data and RotNet on unlabelled
  data. Feature nets, moments and distances run in float32 with TF32 off
  on the card (``utils/precision.py``). Each draws its own stream,
  ``step_generator(seed, i, "eval")`` at the JAX package's indices: 1 the
  real stats, 3 precision/recall and fid_refine, 4 KID, 5 intra-FID;
* ``select_hparams``: the per-checkpoint (K, rate[, objective][, space]
  [, stop][, prox]) grid with its cell cache, retries, boundary warning
  and geometric extension (JAX ``pipeline.py:850-1005``; held to it in
  ``tests/test_torch_tune.py``: the same cells in the same order, the same
  best, warning and extensions, and caches that cross between the two);
* ``benchmark``: the five methods side by side into ``benchmark.jsonl``
  (JAX ``:1007-1019``), and ``profile``: a ``torch.profiler`` trace of
  train chunks and one refinement run (JAX ``:773-795``);
* ``export``: the serving round as a self-contained ``torch.export``
  artifact (``sampling/export.py``; JAX ``:329-362``);
* figures: ``train.viz_every`` (a sample grid, or for 2D the overview, every
  that many iterations; JAX ``:748-770``), ``train.tensorboard`` (the
  metrics mirrored to ``<workdir>/tb``) and ``teaser`` (JAX ``:797-833``).

Everything runs on the card unless ``device`` says otherwise.

``use_mesh`` (JAX ``pipeline.py:117-137``): data-parallel over the process
group that ``parallel/multihost.py`` brought up, one process per card,
when it has more than one process (JAX: more than one device). Train,
refine and shaping batches are sharded over the ranks (``parallel/mesh.py``;
their sizes must divide by the world size); every rank holds the same
state and the same whole sample results, and evaluation runs unsharded on
each, as in JAX. Only rank 0 writes files (checkpoints, ``train.jsonl``,
the TensorBoard mirror, figures, the shaped D, caches, logs and
artifacts); the ranks meet at a barrier after each write.
"""

from __future__ import annotations

import copy
import dataclasses
import json
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
from collaborative_gan_sampling_torch.evals.features import (
    make_feature_fn,
    train_classifier_features,
    train_rotation_features,
)
from collaborative_gan_sampling_torch.evals.fid import (
    frechet_distance,
    frechet_distance_host,
    load_stats,
    per_class_fid,
    save_stats,
    stats_from_features,
    streaming_stats,
)
from collaborative_gan_sampling_torch.evals.kid import kid
from collaborative_gan_sampling_torch.evals.metrics2d import metrics_2d
from collaborative_gan_sampling_torch.evals.prd import precision_recall
from collaborative_gan_sampling_torch.models import make_bundle
from collaborative_gan_sampling_torch.parallel.mesh import (
    barrier,
    check_divisible,
    make_group,
    rank,
    replicate,
    world_size,
)
from collaborative_gan_sampling_torch.sampling.collab import (
    METHODS,
    SampleResult,
    sample,
)
from collaborative_gan_sampling_torch.sampling.fid_refine import (
    make_fid_refine_fn,
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
from collaborative_gan_sampling_torch.utils.prng import (
    fold_generator,
    step_generator,
)
from collaborative_gan_sampling_torch.utils.retry import with_retries
from collaborative_gan_sampling_torch.utils.weights import (
    load_jax_variables,
    to_jax_variables,
)

def shaped_d_path(workdir: str) -> str:
    """Where a workdir's persisted shaped discriminator lives."""
    return os.path.join(workdir, "shaped_d.msgpack")


def _append_cache_line(cache_path: str, cell: tuple, metrics: dict) -> None:
    """Append one grid cell's record, ``{"cell": [...], "metrics": {...}}``
    (the JAX package's line, so either package reads the other's cache),
    under an exclusive lock: writers that share a cache must not tear or
    interleave lines."""
    import fcntl

    with open(cache_path, "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            fh.write(json.dumps({"cell": list(cell),
                                 "metrics": metrics}) + "\n")
            fh.flush()
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def _grid_edges(best: tuple, ks: list, rates: list) -> list[str]:
    """The edges of the swept (K, rate) grid that the best cell lies on: a
    subset of ["k:low", "k:high", "rate:low", "rate:high"]. An axis of one
    value has no edge (nothing was swept), and K = 1 is no low edge (there
    is nothing below it)."""
    edges = []
    k, rate = best[0], best[1]
    if len(set(ks)) > 1:
        if k == min(ks) and k > 1:
            edges.append("k:low")
        elif k == max(ks):
            edges.append("k:high")
    if len(set(rates)) > 1:
        if rate == min(rates):
            edges.append("rate:low")
        elif rate == max(rates):
            edges.append("rate:high")
    return edges


def _extend_axis(vals: list, side: str, integer: bool) -> int | float | None:
    """One geometric step past the ``side`` ("low" or "high") edge of a
    grid axis, at the ratio of its two outermost values; None where the
    axis cannot grow (K's floor of 1, a value already on the axis, or a
    rate that would not be positive)."""
    s = sorted(set(vals))
    if len(s) < 2:
        return None
    if side == "low":
        new = s[0] * (s[0] / s[1])
    else:
        new = s[-1] * (s[-1] / s[-2])
    if integer:
        new = max(1, int(round(new)))
        return new if new not in s else None
    new = float(f"{new:.6g}")
    return new if new not in s and new > 0 else None


class Experiment:
    def __init__(self, cfg: Config, use_mesh: bool = False,
                 echo_metrics: bool = True,
                 device: str | torch.device | None = None):
        self.cfg = cfg.validate()
        self.bundle = make_bundle(cfg.model, device)
        self.device = self.bundle.device
        self.seed = cfg.seed
        self.workdir = cfg.workdir
        self.ckpt_dir = os.path.join(cfg.workdir, "ckpts")
        self.group = (make_group(cfg.mesh.data_axis) if use_mesh
                      and torch.distributed.is_initialized()
                      and torch.distributed.get_world_size() > 1 else None)
        if self.group is not None:
            check_divisible({"train.batch_size": cfg.train.batch_size,
                             "refine.batch_size": cfg.refine.batch_size},
                            world_size(self.group))
        self.writes = rank(self.group) == 0  # the rank that writes files
        self._echo = echo_metrics and self.writes

        self.is_2d = cfg.model.kind == "mlp"
        if self.is_2d:
            self.spec = make_mixture(cfg.data.dataset, cfg.data.ring_radius,
                                     cfg.data.mixture_std, device=self.device)

            def data_fn(generator, n):
                return sample_mixture(generator, self.spec, n), None
        else:
            self.dataset = load_image_dataset(
                cfg.data, image_size=cfg.model.image_size, device=self.device)
            conditional = self.bundle.conditional
            if conditional and (self.dataset.num_classes
                                > cfg.model.num_classes):
                raise ValueError(
                    f"model.num_classes={cfg.model.num_classes} is smaller "
                    f"than the dataset's {self.dataset.num_classes} classes "
                    f"({self.dataset.name}): its labels would index past the "
                    "label embeddings")

            def data_fn(generator, n):
                x, labels = self.dataset.batch(generator, n)
                return x, (labels if conditional else None)

        self.data_fn = data_fn

    # -- training -----------------------------------------------------------

    def train(self, niters: int | None = None, resume: bool = True,
              state: TrainState | None = None) -> TrainState:
        """Train to ``niters`` (default ``train.niters``) iterations, from
        the latest checkpoint when ``resume``. A log line goes to
        ``train.jsonl`` every ``log_every`` iterations (and at the end) with
        the chunk's mean metrics and the iterations per second since the
        previous line (mirrored to ``<workdir>/tb`` with
        ``train.tensorboard``); checkpoints every ``ckpt_every`` and at the
        end; figures every ``viz_every`` (``_training_viz``)."""
        cfg = self.cfg
        niters = niters if niters is not None else cfg.train.niters
        if state is None:
            state = create_train_state(self.bundle, cfg.train, self.seed)
            if resume:
                path = latest_checkpoint(self.ckpt_dir)
                if path:
                    state = restore_checkpoint(path, target=state,
                                               config=cfg)
        replicate(self.group, (state.g, state.d, state.g_ema))
        spc = cfg.train.steps_per_call
        chunk = make_train_chunk(self.bundle, cfg.train, self.data_fn,
                                 self.seed, group=self.group)
        # From-scratch runs truncate the log; resumes append to it.
        writer = MetricsWriter(self._path("train.jsonl"), echo=self._echo,
                               tensorboard_dir=(self._path("tb")
                                                if cfg.train.tensorboard
                                                else None),
                               append=state.step > 0)
        tail_chunk = None
        t_last, step_last = time.perf_counter(), state.step
        try:
            while state.step < niters:
                remaining = niters - state.step
                if remaining < spc:  # the tail chunk stops at niters
                    if tail_chunk is None:
                        tail_chunk = make_train_chunk(
                            self.bundle, cfg.train, self.data_fn, self.seed,
                            steps_per_call=remaining, group=self.group)
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
                    self._write(lambda: save_checkpoint(
                        self.ckpt_dir, step, state, config=cfg))
                if cfg.train.viz_every and step % cfg.train.viz_every < spc:
                    self._write(lambda: self._training_viz(state, step))
        finally:
            writer.close()
        return state

    def _path(self, name: str) -> str | None:
        """``<workdir>/name`` for a log that only the writing rank keeps;
        None on the other ranks."""
        return os.path.join(self.workdir, name) if self.writes else None

    def _write(self, fn):
        """``fn()`` (a file write) on the writing rank only, then a
        barrier of the group's ranks; its result (None on the others)."""
        out = fn() if self.writes else None
        barrier(self.group)
        return out

    def load_state(self) -> TrainState:
        """Restore the latest training checkpoint (the sampling phases'
        entry condition)."""
        path = latest_checkpoint(self.ckpt_dir)
        if path is None:
            raise FileNotFoundError(
                f"no checkpoint under {self.ckpt_dir}; run train first")
        state = create_train_state(self.bundle, self.cfg.train, self.seed)
        state = restore_checkpoint(path, target=state, config=self.cfg)
        replicate(self.group, (state.g, state.d, state.g_ema))
        return state

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
        cond_fn = (self.dataset.batch_by_labels if self.bundle.conditional
                   and self.dataset.labels is not None else None)
        return sample(self.bundle, sampling_g(state), d,
                      refine_cfg or self.cfg.refine, gen, method=method,
                      data_fn=self.data_fn, cond_data_fn=cond_fn,
                      group=self.group)

    def generate(self, state: TrainState, n: int, method: str | None = None,
                 use_shaped_d: bool = False,
                 generator: torch.Generator | None = None,
                 out: str | None = None, class_id: int | None = None):
        """Serving: at least ``n`` accepted samples through
        ``ServingSampler`` (all of class ``class_id`` where given). collab
        serves under a shaped D: the persisted one, or else one collab pass
        shapes D first (drawing from the same generator) and persists it.
        Returns (samples, labels, stats); with ``out``, also writes the
        samples (and labels) to an .npz."""
        method = method or self.cfg.refine.method
        gen = generator or step_generator(self.seed, 9, "eval", self.device)
        d = self._serving_d(state, method, use_shaped_d, gen)
        srv = ServingSampler(self.bundle, self.cfg.refine, method=method,
                             class_id=class_id, group=self.group)
        samples, labels, stats = srv.generate(sampling_g(state), d, gen, n)
        if out:
            arrays = {"samples": samples.numpy()}
            if labels is not None:
                arrays["labels"] = labels.numpy()
            self._write(lambda: np.savez(out, **arrays))
            stats["out"] = out
        return samples, labels, stats

    def export(self, state: TrainState, out: str, method: str | None = None,
               use_shaped_d: bool = False, class_id: int | None = None,
               generator: torch.Generator | None = None) -> dict:
        """The serving round as a self-contained ``torch.export`` artifact
        at ``out`` (``sampling/export.py``): the weights, the DRS
        calibration and, for collab, the shaped D baked in. The shaped D is
        found or made as ``generate`` does it, from the same generator, by
        default ``step_generator(seed, 11, "eval")``. Returns the sidecar
        meta dict. Data-parallel, the shaped D is made over the group and
        the artifact (one process's program, as JAX exports without the
        mesh) is written by rank 0; the other ranks read its sidecar."""
        from collaborative_gan_sampling_torch.sampling.export import (
            export_sampler,
        )

        method = method or self.cfg.refine.method
        gen = generator or step_generator(self.seed, 11, "eval",
                                          self.device)
        d = self._serving_d(state, method, use_shaped_d, gen)
        srv = ServingSampler(self.bundle, self.cfg.refine, method=method,
                             class_id=class_id)
        meta = self._write(lambda: export_sampler(srv, sampling_g(state), d,
                                                  gen, out))
        if meta is None:
            with open(out + ".json") as fh:
                meta = json.load(fh)
        return meta

    def _serving_d(self, state: TrainState, method: str, use_shaped_d: bool,
                   generator: torch.Generator) -> torch.nn.Module:
        """The D that serving runs under: for collab the persisted shaped
        D, or else one collab pass (drawing from ``generator``) shapes and
        persists it; the persisted one for any method with
        ``use_shaped_d``; else the trained D."""
        if method == "collab" and not (use_shaped_d or os.path.exists(
                shaped_d_path(self.workdir))):
            res = self.sample(state, method="collab", generator=generator)
            self.save_shaped_d(res)
            return res.aux["shaped_d"]
        if method == "collab" or use_shaped_d:
            return self.load_shaped_d(template=state.d)
        return state.d

    # -- shaped-D persistence -----------------------------------------------

    def save_shaped_d(self, result: SampleResult) -> str:
        """Persist the shaped D of a collab run (Flax variables, msgpack),
        so later runs refine under it without shaping again."""
        shaped = result.aux.get("shaped_d")
        if shaped is None:
            raise ValueError("result has no shaped_d (only collab sampling "
                             "shapes D)")
        path = shaped_d_path(self.workdir)

        def write():
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "wb") as fh:
                fh.write(msgpack.packb(to_jax_variables(shaped)))
            os.replace(tmp, path)

        self._write(write)
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
        if self.is_2d:
            return self.evaluate_2d(result)
        self._feature_fn()  # the label
        out = {"fid": self.fid_of_samples(result.samples, result.accepted),
               "accept_rate": result.accept_rate,
               "feature_net": self._feature_label}
        if self.cfg.eval.prd_samples > 0:
            out.update(self.precision_recall(result))
        if self.cfg.eval.kid_subsets > 0:
            out.update(self.kid(result))
        if (self.cfg.eval.intra_fid_classes > 0 and self.bundle.conditional
                and result.labels is not None):
            out.update(self.intra_fid(result))
        return out

    def evaluate_2d(self, result: SampleResult) -> dict[str, float]:
        m = metrics_2d(result.samples, self.spec,
                       hq_std=self.cfg.eval.hq_std,
                       weights=result.accepted.float())
        out = {k: float(v) for k, v in m.items()}
        out["accept_rate"] = result.accept_rate
        return out

    def _feature_fn(self):
        """The feature net, built once: on image data "auto" trains the
        classifier on labelled data and RotNet on unlabelled data;
        otherwise ``make_feature_fn``."""
        if not hasattr(self, "_cached_feature_fn"):
            cfg = self.cfg.eval
            labels = getattr(getattr(self, "dataset", None), "labels", None)
            kw = dict(steps=cfg.feature_train_steps, seed=self.seed,
                      device=self.device)
            if cfg.feature_net == "auto" and not self.is_2d \
                    and labels is not None:
                self._cached_feature_fn, _ = train_classifier_features(
                    self.dataset.batch, int(labels.max()) + 1,
                    self.bundle.data_shape, **kw)
                self._feature_label = "torch/trained_classifier"
            elif cfg.feature_net == "auto" and not self.is_2d:
                self._cached_feature_fn, _ = train_rotation_features(
                    lambda gen, n: self.data_fn(gen, n)[0],
                    self.bundle.data_shape, **kw)
                self._feature_label = "torch/rotnet"
            else:
                self._cached_feature_fn, self._feature_label = \
                    make_feature_fn(cfg.feature_net, self.bundle.data_shape,
                                    seed=self.seed, device=self.device)
        return self._cached_feature_fn

    def adopt_eval_caches(self, src: "Experiment",
                          include_real_stats: bool | None = None) -> None:
        """Take ``src``'s feature net (and its real stats, when both
        configs agree on eval.fid_num_samples / fid_batch_size, or as
        ``include_real_stats`` says), so that two Experiments over the same
        data score in one feature space without training it twice. Asking
        for the real stats across protocols raises."""
        self._cached_feature_fn = src._feature_fn()
        self._feature_label = src._feature_label
        same_protocol = (
            src.cfg.eval.fid_num_samples == self.cfg.eval.fid_num_samples
            and src.cfg.eval.fid_batch_size == self.cfg.eval.fid_batch_size)
        if include_real_stats is None:
            include_real_stats = same_protocol
        if include_real_stats:
            if not same_protocol:
                raise ValueError(
                    "adopt_eval_caches(include_real_stats=True) across "
                    "different eval protocols: src has "
                    f"{src.cfg.eval.fid_num_samples}/"
                    f"{src.cfg.eval.fid_batch_size} samples/batch, self has "
                    f"{self.cfg.eval.fid_num_samples}/"
                    f"{self.cfg.eval.fid_batch_size} — the real-side stats "
                    "would mislabel the protocol")
            if hasattr(src, "_real_stats"):
                self._real_stats = src._real_stats

    def real_stats(self, generator: torch.Generator | None = None):
        """(mu, Sigma) of eval.fid_num_samples real images under the feature
        net, computed once per process; with eval.real_stats_path also
        loaded from / saved to that npz. A file of another feature net (by
        its label) or another feature width is refused."""
        if not hasattr(self, "_real_stats"):
            cfg = self.cfg.eval
            gen = generator or step_generator(self.seed, 1, "eval",
                                              self.device)
            feature_fn = self._feature_fn()
            if cfg.real_stats_path and os.path.exists(cfg.real_stats_path):
                stats, label = load_stats(cfg.real_stats_path, self.device)
                if label and label != self._feature_label:
                    raise ValueError(
                        f"{cfg.real_stats_path} was computed under feature "
                        f"net {label!r} but this run uses "
                        f"{self._feature_label!r} — FID across feature nets "
                        "is meaningless; recompute or fix eval.feature_net")
                with torch.no_grad():
                    fdim = feature_fn(torch.zeros(
                        (1, *self.bundle.data_shape),
                        device=self.device)).shape[-1]
                if stats.mu.shape[0] != fdim:
                    raise ValueError(
                        f"{cfg.real_stats_path}: stats are {stats.mu.shape[0]}"
                        f"-dim but the feature net emits {fdim}-dim features")
                self._real_stats = stats
                return self._real_stats
            nb = max(1, cfg.fid_num_samples // cfg.fid_batch_size)
            self._real_stats = streaming_stats(
                feature_fn, lambda g, n: self.data_fn(g, n)[0], nb,
                cfg.fid_batch_size, gen)
            if cfg.real_stats_path:
                self._write(lambda: save_stats(
                    cfg.real_stats_path, self._real_stats,
                    feature_net=self._feature_label))
        return self._real_stats

    @staticmethod
    def _accepted_pool(result: SampleResult, n: int | None = None):
        """(accepted samples, their labels or None), the first ``n``: the one
        definition of the pool that an evaluation scores."""
        samples, labels = result.samples, result.labels
        if result.accepted is not None:
            mask = result.accepted.bool()
            samples = samples[mask]
            labels = labels[mask] if labels is not None else None
        if n is not None:
            samples = samples[:n]
            labels = labels[:n] if labels is not None else None
        return samples, labels

    def _feats_of(self, x: torch.Tensor, bs: int
                  ) -> tuple[torch.Tensor, int]:
        """Features of ``x`` in batches of ``bs`` (in [1, len(x)]), the
        remainder dropped: (features, rows used)."""
        feature_fn = self._feature_fn()
        m = (x.shape[0] // bs) * bs
        with torch.no_grad():
            f = torch.cat([feature_fn(x[i:i + bs]) for i in range(0, m, bs)])
        return f, m

    def fid_of_samples(self, samples: torch.Tensor,
                       accepted: torch.Tensor | None = None) -> float:
        """FID between the real stats and ``samples`` (or their accepted
        subset); inf for an empty pool. The distance is the float64 host
        one, or with eval.newton_schulz_iters > 0 the float32 Newton-Schulz
        one on the device."""
        self._feature_fn()
        if accepted is not None:
            samples = samples[accepted.bool()]
        if samples.shape[0] == 0:
            return float("inf")
        bs = min(self.cfg.eval.fid_batch_size, samples.shape[0])
        stats = stats_from_features(self._feats_of(samples, bs)[0])
        ns_iters = self.cfg.eval.newton_schulz_iters
        if ns_iters > 0:
            return float(frechet_distance(stats, self.real_stats(),
                                          ns_iters))
        return frechet_distance_host(stats, self.real_stats())

    def intra_fid(self, result: SampleResult) -> dict[str, float]:
        """Per-class FID (``evals/fid.py::per_class_fid``) of the first
        eval.fid_num_samples accepted samples against as many real ones,
        averaged over the eval.intra_fid_classes most frequent classes of
        the pool that have eval.intra_fid_min_count samples on both sides;
        inf for an empty pool."""
        if result.labels is None:
            raise ValueError("intra_fid needs the pool's labels (a "
                             "class-conditional model's samples)")
        ecfg = self.cfg.eval
        n = ecfg.fid_num_samples
        self._feature_fn()
        samples, labels_f = self._accepted_pool(result, n)
        if samples.shape[0] == 0:
            return {"intra_fid": float("inf"), "intra_fid_classes": 0.0}
        gen = step_generator(self.seed, 5, "eval", self.device)
        x_real, labels_r = self.dataset.batch(gen, min(n, samples.shape[0]))
        bs = min(ecfg.fid_batch_size, samples.shape[0], x_real.shape[0])
        fr, mr = self._feats_of(x_real, bs)
        ff, mf = self._feats_of(samples, bs)
        res = per_class_fid(fr, labels_r[:mr], ff, labels_f[:mf],
                            min_count=ecfg.intra_fid_min_count,
                            max_classes=ecfg.intra_fid_classes)
        return {"intra_fid": res["intra_fid"],
                "intra_fid_classes": res["intra_fid_classes"]}

    def kid(self, result: SampleResult, n: int | None = None
            ) -> dict[str, float]:
        """KID (arXiv:1801.01401) in the FID's feature space, mean and std
        over eval.kid_subsets subsets; inf for a pool of fewer than 2."""
        ecfg = self.cfg.eval
        n = n or ecfg.fid_num_samples
        self._feature_fn()
        samples, _ = self._accepted_pool(result, n)
        if samples.shape[0] < 2:
            return {"kid": float("inf"), "kid_std": 0.0}
        gen = step_generator(self.seed, 4, "eval", self.device)
        x_real, _ = self.data_fn(gen, min(n, samples.shape[0]))
        bs = min(ecfg.fid_batch_size, samples.shape[0], x_real.shape[0])
        mean, std = kid(self._feats_of(x_real, bs)[0],
                        self._feats_of(samples, bs)[0],
                        fold_generator(gen, 1), n_subsets=ecfg.kid_subsets,
                        subset_size=ecfg.kid_subset_size)
        return {"kid": float(mean), "kid_std": float(std)}

    def precision_recall(self, result: SampleResult,
                         n: int | None = None) -> dict[str, float]:
        """Improved precision / recall (arXiv:1904.06991) in the FID's
        feature space; zeros for a pool of at most eval.prd_k points."""
        n = n or self.cfg.eval.prd_samples or 2048
        self._feature_fn()
        samples, _ = self._accepted_pool(result, n)
        if samples.shape[0] <= self.cfg.eval.prd_k:
            return {"precision": 0.0, "recall": 0.0}
        gen = step_generator(self.seed, 3, "eval", self.device)
        x_real, _ = self.data_fn(gen, n)
        bs = min(self.cfg.eval.fid_batch_size, samples.shape[0], n)
        pr = precision_recall(self._feats_of(x_real, bs)[0],
                              self._feats_of(samples, bs)[0],
                              k=self.cfg.eval.prd_k)
        return {k: float(v) for k, v in pr.items()}

    def fid_refine(self, state: TrainState,
                   generator: torch.Generator | None = None,
                   steps: int | None = None,
                   rate: float | None = None) -> SampleResult:
        """FID-backprop refinement (arXiv:2009.14075) of refine.num_batches
        batches of G samples toward the real stats
        (``sampling/fid_refine.py``); all accepted. aux holds the batches'
        mean loss at x0 and at x_K (``batch_fid_start``,
        ``batch_fid_end``)."""
        gen = generator or step_generator(self.seed, 3, "eval", self.device)
        cfg = self.cfg.refine
        refine = make_fid_refine_fn(self._feature_fn(), self.real_stats(),
                                    steps or cfg.steps, rate or cfg.rate)
        g, xs, labels, logits, starts, ends = (sampling_g(state), [], [], [],
                                               [], [])
        for i in range(cfg.num_batches):
            gen_i = fold_generator(gen, i)
            z = self.bundle.sample_z(gen_i, cfg.batch_size)
            lab = self.bundle.sample_labels(gen_i, cfg.batch_size)
            with torch.no_grad():
                x0 = self.bundle.generate(g, z, lab)
            x, aux = refine(x0)
            with torch.no_grad():
                logits.append(self.bundle.discriminate(state.d, x, lab))
            xs.append(x)
            labels.append(lab)
            starts.append(aux["fid_start"])
            ends.append(aux["fid_end"])
        samples = torch.cat(xs)
        return SampleResult(
            samples, torch.ones(samples.shape[0], dtype=torch.bool,
                                device=samples.device),
            torch.cat(logits),
            torch.cat(labels) if self.bundle.conditional else None,
            {"batch_fid_start": torch.stack(starts).mean(),
             "batch_fid_end": torch.stack(ends).mean()})

    def sweep(self, state: TrainState, ks: list[int],
              method: str = "refinement") -> dict[int, dict]:
        """``evaluate`` of ``method`` at each refinement depth k in ``ks``;
        the feature net and the real stats are computed once."""
        out = {}
        for k in ks:
            rcfg = dataclasses.replace(self.cfg.refine, steps=k)
            out[k] = self.evaluate(self.sample(state, method=method,
                                               refine_cfg=rcfg))
        return out

    def select_k(self, state: TrainState, ks: list[int] | None = None,
                 method: str = "refinement",
                 metric: str | None = None) -> tuple[int, dict[int, dict]]:
        """The refinement depth K that minimises FID (images) or mode KL
        (2D) over ``sweep(ks)`` (default 1 .. 50, log-spaced): (best K, the
        whole table)."""
        ks = ks or [1, 2, 5, 10, 20, 50]
        metric = metric or ("kl" if self.is_2d else "fid")
        table = self.sweep(state, ks, method=method)
        return min(table, key=lambda k: table[k][metric]), table

    def select_hparams(self, state: TrainState,
                       ks: list[int] | None = None,
                       rates: list[float] | None = None,
                       method: str = "refinement",
                       metric: str | None = None,
                       objectives: list[str] | None = None,
                       spaces: list[str] | None = None,
                       stops: list[float] | None = None,
                       proxs: list[float] | None = None,
                       progress: bool = False,
                       cache_path: str | None = None,
                       extend_grid: int = 0,
                       ) -> tuple[tuple, dict]:
        """Per-checkpoint tuning of the refinement: ``evaluate`` of
        ``method`` at every cell of the grid ks x rates (default 1, 5, 10,
        20 and ``_default_rate_grid``), and of ``objectives``, ``spaces``,
        ``stops`` (stop_score) and ``proxs`` (proximal) where given; the
        best cell minimises ``metric`` (FID on images, mode KL in 2D). The
        feature net and the real stats are built once.

        Returns (best cell, {cell: metrics}); a cell is (k, rate[, obj]
        [, space][, stop][, prox]). Cells run in the JAX package's order (K
        fastest, then rate, objective, space, stop, prox), each under
        ``with_retries``. With ``cache_path``, finished cells are read from
        and appended to that JSONL file (torn lines skipped, later
        duplicates win). A best cell on the edge of the (K, rate) grid
        prints a warning; with ``extend_grid`` > 0 the offending axes grow
        by one geometric step, up to that many times, until it is
        interior."""
        ks = list(ks or [1, 5, 10, 20])
        rates = list(rates if rates is not None
                     else self._default_rate_grid())
        metric = metric or ("kl" if self.is_2d else "fid")
        rcfg0 = self.cfg.refine
        axes = [(objectives, rcfg0.objective), (spaces, rcfg0.space),
                (stops, rcfg0.stop_score), (proxs, rcfg0.proximal)]
        objs, spcs, stps, prxs = (vals if vals is not None else [default]
                                  for vals, default in axes)
        swept = [vals is not None for vals, _ in axes]
        cached: dict[tuple, dict] = {}
        if cache_path and os.path.exists(cache_path):
            with open(cache_path) as fh:
                for line in fh:
                    try:
                        rec = json.loads(line)
                        cached[tuple(rec["cell"])] = rec["metrics"]
                    except (json.JSONDecodeError, KeyError, TypeError):
                        continue
        table: dict[tuple, dict] = {}

        def run_cell(rcfg):
            return self.evaluate(self.sample(state, method=method,
                                             refine_cfg=rcfg))

        def run_cells(ks_now: list, rates_now: list) -> None:
            for prox in prxs:
                for stop in stps:
                    for space in spcs:
                        for obj in objs:
                            for rate in rates_now:
                                for k in ks_now:
                                    extra = (obj, space, stop, prox)
                                    cell = (k, rate) + tuple(
                                        v for v, on in zip(extra, swept)
                                        if on)
                                    if cell in table:
                                        continue
                                    if cell in cached:
                                        table[cell] = cached[cell]
                                        if progress:
                                            print(
                                                f"[select_hparams] {cell} "
                                                f"(cached) -> {metric}="
                                                f"{table[cell][metric]:.4f}",
                                                flush=True)
                                        continue
                                    rcfg = dataclasses.replace(
                                        rcfg0, steps=k, rate=rate,
                                        objective=obj, space=space,
                                        stop_score=stop, proximal=prox)
                                    t0 = time.perf_counter()
                                    table[cell] = with_retries(
                                        lambda rcfg=rcfg: run_cell(rcfg),
                                        label=f"grid {cell}")
                                    cell_s = time.perf_counter() - t0
                                    if cache_path and self.writes:
                                        _append_cache_line(
                                            cache_path, cell, table[cell])
                                    if progress:
                                        print(f"[select_hparams] {cell} -> "
                                              f"{metric}="
                                              f"{table[cell][metric]:.4f} "
                                              f"({cell_s:.0f}s)",
                                              flush=True)

        extensions = 0
        while True:
            run_cells(ks, rates)
            best = min(table, key=lambda cell: table[cell][metric])
            edges = _grid_edges(best, ks, rates)
            if not edges:
                break
            if extensions >= extend_grid:
                print(f"[select_hparams] WARNING: best cell {best} lies on "
                      f"the {'/'.join(edges)} edge of the swept grid — the "
                      "true optimum is plausibly outside it (pass "
                      "extend_grid>0 to auto-extend)", flush=True)
                break
            grew = False
            for edge in edges:
                axis, side = edge.split(":")
                vals = ks if axis == "k" else rates
                new = _extend_axis(vals, side, integer=(axis == "k"))
                if new is not None:
                    vals.append(new)
                    vals.sort()
                    grew = True
                    if progress:
                        print(f"[select_hparams] extending {axis} grid "
                              f"{side} -> {new}", flush=True)
            if not grew:  # K already at its floor of 1
                break
            extensions += 1
        return best, table

    def _default_rate_grid(self) -> list[float]:
        """A grid of rates around the preset's: 1/4, 1/2, 1, 2 and 4
        times it."""
        base = self.cfg.refine.rate
        return [round(base * m, 6) for m in (0.25, 0.5, 1.0, 2.0, 4.0)]

    # -- benchmark and profile ----------------------------------------------

    def benchmark(self, state: TrainState,
                  methods: tuple[str, ...] = METHODS) -> dict[str, dict]:
        """The methods side by side: ``evaluate`` of ``sample`` under each,
        one ``benchmark.jsonl`` line apiece (``phase="benchmark"``,
        ``method`` and the metrics, as the JAX package writes them)."""
        writer = MetricsWriter(self._path("benchmark.jsonl"),
                               echo=self._echo)
        table = {}
        try:
            for method in methods:
                table[method] = self.evaluate(self.sample(state,
                                                          method=method))
                writer.write(state.step, phase="benchmark", method=method,
                             **table[method])
        finally:
            writer.close()
        return table

    def profile(self, state: TrainState | None = None,
                chunks: int = 3) -> str:
        """A ``torch.profiler`` trace (``utils/profiling.py::trace``) of
        ``chunks`` train chunks, each under ``record_function("train_chunk")``,
        and one ``sample(method="refinement")`` under
        ``record_function("refinement")``, after one warm chunk outside it.
        Trains ``state`` further. Returns the trace's directory,
        ``<workdir>/trace``; data-parallel, every rank runs the same work
        and rank 0 records it."""
        from torch.profiler import record_function

        from collaborative_gan_sampling_torch.utils.profiling import (
            block,
            trace,
        )

        state = state if state is not None else self.load_or_train()
        chunk = make_train_chunk(self.bundle, self.cfg.train, self.data_fn,
                                 self.seed, group=self.group)
        state, m = chunk(state)  # first-call set-up outside the trace
        block(m)
        logdir = os.path.join(self.workdir, "trace")
        with trace(self._path("trace")):
            for _ in range(chunks):
                with record_function("train_chunk"):
                    state, m = chunk(state)
                    block(m)
            with record_function("refinement"):
                block(self.sample(state, method="refinement").samples)
        return logdir

    # -- figures ------------------------------------------------------------

    def _training_viz(self, state: TrainState, step: int) -> None:
        """The periodic training figure: 64 samples of the live G from
        ``step_generator(seed, step, "eval")`` as a grid
        (``samples_<step>.png``), or for 2D the overview with 512 real
        points (``viz_<step>.png``)."""
        from collaborative_gan_sampling_torch.viz import (
            plot_2d_overview,
            save_image_grid,
        )

        gen = step_generator(self.seed, step, "eval", self.device)
        n = 64
        z = self.bundle.sample_z(gen, n)
        labels = (self.bundle.sample_labels(fold_generator(gen, 1), n)
                  if self.bundle.conditional else None)
        with torch.no_grad():
            x = self.bundle.generate(state.g, z, labels, train=False)
        if self.is_2d:
            x_real, _ = self.data_fn(fold_generator(gen, 2), 512)
            plot_2d_overview(
                os.path.join(self.workdir, f"viz_{step:08d}.png"),
                self.bundle, state.d, self.spec, x_real, x,
                title=f"step {step}")
        else:
            save_image_grid(
                os.path.join(self.workdir, f"samples_{step:08d}.png"), x)

    def teaser(self, state: TrainState | None = None,
               n_points: int = 256) -> dict[str, str]:
        """The 2D figures: refinement trajectories, the overview and the
        animated teaser of ``n_points`` samples from
        ``step_generator(seed, 2, "eval")``. The refinement runs through
        ``make_refine_fn(..., return_trajectory=True)`` with the kernels
        off (``use_pallas=False``, as the JAX package sets it): a kernel
        returns only x_K, not the steps between."""
        if not self.is_2d:
            raise ValueError("teaser is a 2D-stack artifact")
        from collaborative_gan_sampling_torch.sampling.refine import (
            make_refine_fn,
        )
        from collaborative_gan_sampling_torch.viz import (
            plot_2d_overview,
            plot_refinement_trajectories,
            save_teaser_gif,
        )

        state = state if state is not None else self.load_or_train()
        gen = step_generator(self.seed, 2, "eval", self.device)
        rcfg = dataclasses.replace(self.cfg.refine, use_pallas=False)
        refine = make_refine_fn(self.bundle, rcfg, return_trajectory=True)
        z = self.bundle.sample_z(gen, n_points)
        with torch.no_grad():
            x0 = self.bundle.generate(sampling_g(state), z)
        x_k, aux = refine(state.d, x0)
        x_real, _ = self.data_fn(fold_generator(gen, 1), n_points * 4)
        paths = {"trajectories": os.path.join(self.workdir,
                                              "teaser_trajectories.png"),
                 "overview": os.path.join(self.workdir, "overview.png"),
                 "gif": os.path.join(self.workdir, "teaser.gif")}

        def draw():
            plot_refinement_trajectories(paths["trajectories"], aux["traj"],
                                         self.spec)
            plot_2d_overview(paths["overview"], self.bundle, state.d,
                             self.spec, x_real, x0, x_k,
                             title=f"{self.cfg.name} @ step {state.step}")
            save_teaser_gif(paths["gif"], aux["traj"], self.spec)

        self._write(draw)
        return paths
