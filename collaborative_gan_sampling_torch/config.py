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
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class ModelConfig:
    """Architecture of the (G, D) pair.

    ``kind='mlp'``: relu MLPs for the 2D synthetic mixtures (``data_dim``,
    ``*_hidden``, ``*_layers``). ``kind='dcgan'``: transposed-conv generator
    and conv discriminator for 28x28x1 .. 64x64x3 images. ``num_classes > 0``
    (class-conditional models) is not ported yet.
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
    space: str = "x"  # 'x' (ported) | 'z' (not ported yet)
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

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)


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
