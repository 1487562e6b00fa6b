"""Typed configuration tree and named presets for the PyTorch port.

The port's own copy of the JAX package's ``config.py``: the same frozen
dataclasses, field names and presets, so a config written for one package
reads the same in the other. Only ``use_pallas`` changes meaning: here it
selects the hand-written CUDA kernels: the DRS accept kernel
(``ops/accept.py``), the conv-D refine kernels (``ops/conv_refine.py``: bf16
operands on the tensor cores for a ``bfloat16`` model, f32 otherwise) and the
MLP-D refine kernel (``ops/refine_mlp.py``).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class ModelConfig:
    """Architecture of the (G, D) pair.

    ``kind='mlp'``: relu MLPs for the 2D synthetic mixtures (``data_dim``,
    ``*_hidden``, ``*_layers``). ``kind='dcgan'``: transposed-conv generator
    and conv discriminator for 28x28x1 .. 64x64x3 images; ``num_classes >
    0`` makes the DCGAN pair class-conditional (a label embedding in G, a
    projection D).
    """

    kind: str = "mlp"  # 'mlp' | 'dcgan'
    z_dim: int = 4
    data_dim: int = 2
    g_hidden: int = 128
    d_hidden: int = 128
    g_layers: int = 3
    d_layers: int = 3
    image_size: int = 32
    channels: int = 3
    g_base_filters: int = 64  # filters in the last deconv stage (gf_dim)
    d_base_filters: int = 64  # filters in the first conv stage (df_dim)
    num_classes: int = 0  # 0 = unconditional
    # Compute dtype of the forward/backward pass. Params stay float32.
    compute_dtype: str = "bfloat16"


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "ring8"
    path: str = ""
    crop_size: int = 108
    ring_radius: float = 2.0
    mixture_std: float = 0.02


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 256
    niters: int = 4000
    d_lr: float = 2e-4
    g_lr: float = 2e-4
    beta1: float = 0.5
    beta2: float = 0.999
    d_steps: int = 1
    g_steps: int = 1
    fused_prop: bool = False
    r1_gamma: float = 0.0
    g_ema_decay: float = 0.0
    steps_per_call: int = 50
    log_every: int = 200
    ckpt_every: int = 1000
    viz_every: int = 0
    tensorboard: bool = False


@dataclass(frozen=True)
class RefineConfig:
    """Sampling-strategy hyperparameters (see the JAX package's
    ``RefineConfig`` for the full discussion of each field)."""

    method: str = "collab"
    steps: int = 10  # K
    rate: float = 0.1  # lambda
    clip_norm: float = 0.0  # 0 = no per-sample gradient clipping
    noise: float = 0.0  # Langevin noise: x += sqrt(2*rate*noise)*N(0, I)
    objective: str = "ns"  # 'ns' | 'kl' | 'saturating'
    space: str = "x"  # 'x' (data space) | 'z' (latent space)
    stop_score: float = 0.0  # freeze a sample once sigmoid(D(x)) >= this
    proximal: float = 0.0  # drift += proximal * (x - x0)
    use_pallas: bool = True  # use the hand kernels where they apply
    use_s2d: bool = True  # JAX-only layout rewrite; the port ignores it
    gamma: float = 0.0  # static DRS acceptance shift
    gamma_percentile: float = 80.0  # dynamic gamma percentile (0 = off)
    burn_in: int = 2048  # samples used to estimate the logit max M
    per_class_drs: bool = False
    eps_drs: float = 1e-6
    mh_chain_len: int = 40
    shape_every: int = 1  # shape D every m refined batches (0 = never)
    shaping_steps: int = 1  # D updates per shaping event
    shaping_lr: float = 1e-4
    shaping_decay: float = 1.0  # update n runs at lr * decay**n
    shaping_target: float = 0.0  # skip when real-vs-refined sep <= target
    class_balanced_shaping: bool = True
    shaping_freeze_embed: bool = False
    shaping_class_weight: bool = False
    shaping_anchor: float = 0.0  # L2-SP pull toward the restored params
    shaping_r1_gamma: float = 0.0  # R1 penalty on the shaping real batch
    num_batches: int = 40
    batch_size: int = 256


@dataclass(frozen=True)
class EvalConfig:
    hq_std: float = 4.0
    fid_num_samples: int = 10000
    fid_batch_size: int = 256
    feature_net: str = "auto"
    feature_train_steps: int = 1500
    real_stats_path: str = ""
    newton_schulz_iters: int = 0
    prd_samples: int = 0
    prd_k: int = 3
    kid_subsets: int = 0
    kid_subset_size: int = 1024
    intra_fid_classes: int = 0
    intra_fid_min_count: int = 32


@dataclass(frozen=True)
class MeshConfig:
    data_axis: int = -1


@dataclass(frozen=True)
class Config:
    name: str = "toy2d"
    seed: int = 0
    workdir: str = "runs/toy2d"
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    refine: RefineConfig = field(default_factory=RefineConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    # -- serialization ------------------------------------------------------

    def to_dict(self) -> dict[str, Any]:
        """``dataclasses.asdict``: the same dict as the JAX package's
        ``Config.to_dict`` for the same config, so the checkpoint sidecar's
        content hash agrees across the two packages."""
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        """``to_dict`` as sorted, indented JSON: the same string as the JAX
        package's ``Config.to_json`` for the same config."""
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Config":
        """Inverse of to_dict, e.g. from a checkpoint dir's ``config.json``.
        Leaf fields unknown to this schema are dropped and absent ones take
        their defaults; the sidecar's hash check stays the strict gate."""
        leaves = {"model": ModelConfig, "data": DataConfig,
                  "train": TrainConfig, "refine": RefineConfig,
                  "eval": EvalConfig, "mesh": MeshConfig}
        kw: dict[str, Any] = {}
        top = {f.name for f in dataclasses.fields(cls)}
        for k, v in d.items():
            if k in leaves:
                known = {f.name for f in dataclasses.fields(leaves[k])}
                kw[k] = leaves[k](**{a: b for a, b in v.items()
                                     if a in known})
            elif k in top:
                kw[k] = v
        return cls(**kw)

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)

    # -- validation ---------------------------------------------------------

    def validate(self) -> "Config":
        """Raise ValueError on configurations that are known to be broken,
        before any device work starts. Returns self for chaining."""
        problems: list[str] = []

        def need(cond: bool, msg: str) -> None:
            if not cond:
                problems.append(msg)

        r, t, e, m = self.refine, self.train, self.eval, self.model
        need(m.z_dim > 0, f"model.z_dim must be > 0, got {m.z_dim}")
        need(m.num_classes >= 0,
             f"model.num_classes must be >= 0, got {m.num_classes}")
        need(t.batch_size > 0,
             f"train.batch_size must be > 0, got {t.batch_size}")
        need(t.niters >= 0, f"train.niters must be >= 0, got {t.niters}")
        need(t.steps_per_call > 0,
             f"train.steps_per_call must be > 0, got {t.steps_per_call}")
        need(0.0 <= t.g_ema_decay < 1.0,
             f"train.g_ema_decay must be in [0, 1), got {t.g_ema_decay}")
        need(t.r1_gamma >= 0.0,
             f"train.r1_gamma must be >= 0, got {t.r1_gamma}")
        need(r.steps >= 0, f"refine.steps must be >= 0, got {r.steps}")
        need(r.rate >= 0.0, f"refine.rate must be >= 0, got {r.rate}")
        need(r.batch_size > 0,
             f"refine.batch_size must be > 0, got {r.batch_size}")
        need(r.num_batches > 0,
             f"refine.num_batches must be > 0, got {r.num_batches}")
        need(r.burn_in > 0, f"refine.burn_in must be > 0, got {r.burn_in}")
        need(0.0 <= r.stop_score < 1.0,
             f"refine.stop_score must be in [0, 1) (a sigmoid threshold; "
             f"1.0 would never trigger), got {r.stop_score}")
        need(r.proximal >= 0.0,
             f"refine.proximal must be >= 0, got {r.proximal}")
        need(r.rate * r.proximal < 2.0,
             f"refine.rate * refine.proximal = {r.rate * r.proximal:g} "
             ">= 2: the explicit-Euler proximal anchor oscillates "
             "divergently (see RefineConfig.proximal) — lower one of them")
        need(0.0 <= r.gamma_percentile <= 100.0,
             f"refine.gamma_percentile must be in [0, 100], got "
             f"{r.gamma_percentile}")
        need(r.shape_every >= 0,
             f"refine.shape_every must be >= 0, got {r.shape_every}")
        need(r.shaping_steps >= 0,
             f"refine.shaping_steps must be >= 0, got {r.shaping_steps}")
        need(r.shaping_r1_gamma >= 0.0,
             f"refine.shaping_r1_gamma must be >= 0, got {r.shaping_r1_gamma}")
        need(e.fid_num_samples > 0 and e.fid_batch_size > 0,
             "eval.fid_num_samples and eval.fid_batch_size must be > 0, "
             f"got {e.fid_num_samples}/{e.fid_batch_size}")
        need(e.prd_k > 0, f"eval.prd_k must be > 0, got {e.prd_k}")
        if problems:
            raise ValueError("invalid config:\n  - " + "\n  - ".join(problems))
        return self


def _toy2d() -> Config:
    return Config(
        name="toy2d",
        workdir="runs/toy2d",
        model=ModelConfig(kind="mlp", z_dim=4, data_dim=2, g_hidden=128,
                          d_hidden=128, g_layers=3, d_layers=3,
                          compute_dtype="float32"),
        data=DataConfig(dataset="ring8_imbalanced", mixture_std=0.1,
                        ring_radius=2.0),
        train=TrainConfig(batch_size=256, niters=4000, d_lr=1e-3, g_lr=1e-3,
                          beta1=0.5),
        refine=RefineConfig(steps=10, rate=0.1, shape_every=1,
                            use_pallas=True),
    )


def _mnist() -> Config:
    return Config(
        name="mnist",
        workdir="runs/mnist",
        model=ModelConfig(kind="dcgan", z_dim=100, image_size=28, channels=1,
                          g_base_filters=64, d_base_filters=64),
        data=DataConfig(dataset="mnist"),
        train=TrainConfig(batch_size=256, niters=4000, d_lr=2e-4, g_lr=2e-4,
                          g_steps=2, steps_per_call=20),
        refine=RefineConfig(steps=10, rate=0.02, shape_every=4,
                            batch_size=256),
    )


def _fmnist() -> Config:
    return _mnist().replace(name="fmnist", workdir="runs/fmnist",
                            data=DataConfig(dataset="fmnist"))


def _cifar10() -> Config:
    return Config(
        name="cifar10",
        workdir="runs/cifar10",
        model=ModelConfig(kind="dcgan", z_dim=100, image_size=32, channels=3,
                          g_base_filters=64, d_base_filters=64),
        data=DataConfig(dataset="cifar10"),
        train=TrainConfig(batch_size=256, niters=20000, d_lr=2e-4, g_lr=2e-4,
                          g_steps=2, steps_per_call=20),
        refine=RefineConfig(steps=10, rate=0.02, shape_every=4,
                            batch_size=256),
    )


def _celeba() -> Config:
    return Config(
        name="celeba",
        workdir="runs/celeba",
        model=ModelConfig(kind="dcgan", z_dim=100, image_size=64, channels=3,
                          g_base_filters=64, d_base_filters=64),
        data=DataConfig(dataset="celeba", crop_size=108),
        train=TrainConfig(batch_size=128, niters=40000, d_lr=2e-4, g_lr=2e-4,
                          g_steps=2, steps_per_call=10),
        refine=RefineConfig(steps=10, rate=0.01, shape_every=4,
                            batch_size=128),
    )


def _imagenet64() -> Config:
    return Config(
        name="imagenet64",
        workdir="runs/imagenet64",
        model=ModelConfig(kind="dcgan", z_dim=128, image_size=64, channels=3,
                          g_base_filters=96, d_base_filters=96,
                          num_classes=1000),
        data=DataConfig(dataset="imagenet64"),
        train=TrainConfig(batch_size=256, niters=100000, d_lr=2e-4, g_lr=2e-4,
                          g_steps=1, steps_per_call=10),
        refine=RefineConfig(steps=10, rate=0.01, shape_every=4,
                            batch_size=256),
    )


_PRESETS = {
    "toy2d": _toy2d,
    "mnist": _mnist,
    "fmnist": _fmnist,
    "cifar10": _cifar10,
    "celeba": _celeba,
    "imagenet64": _imagenet64,
}


def list_presets() -> list[str]:
    return sorted(_PRESETS)


def get_preset(name: str) -> Config:
    if name not in _PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {list_presets()}")
    return _PRESETS[name]()


# ---------------------------------------------------------------------------
# CLI overrides: train.batch_size=128 refine.steps=50 model.kind=dcgan
# ---------------------------------------------------------------------------


def _cast(value: str, typ: Any) -> Any:
    if typ is bool:
        if value.lower() in ("1", "true", "yes", "on"):
            return True
        if value.lower() in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"cannot parse bool from {value!r}")
    return typ(value)


def apply_overrides(cfg: Config, overrides: list[str]) -> Config:
    """Apply ``a.b=c`` style dotted overrides to a frozen config tree."""
    for ov in overrides:
        ov = ov.lstrip("-")
        if "=" not in ov:
            raise ValueError(f"override {ov!r} is not of the form key=value")
        dotted, value = ov.split("=", 1)
        cfg = _set_path(cfg, dotted.split("."), value)
    return cfg


def _set_path(node: Any, path: list[str], value: str) -> Any:
    name = path[0]
    fields = {f.name: f for f in dataclasses.fields(node)}
    if name not in fields:
        raise KeyError(
            f"{type(node).__name__} has no field {name!r}; "
            f"have {sorted(fields)}")
    if len(path) == 1:
        typ = type(getattr(node, name))
        return dataclasses.replace(node, **{name: _cast(value, typ)})
    child = _set_path(getattr(node, name), path[1:], value)
    return dataclasses.replace(node, **{name: child})
