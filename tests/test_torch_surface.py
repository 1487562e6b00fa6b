"""The port's public surface against the JAX package's: every public
top-level function and class of ``collaborative_gan_sampling_tpu`` and every
public method of its classes has a twin of the same name in
``collaborative_gan_sampling_torch``, or stands in one of two written lists:
renamed in the port (with the port's name, which must exist), or not to port
(with the item of ``ROADMAP.md``'s "Not to port" list that gives the reason).
Both packages are read as source with ``ast``; nothing is imported. A JAX
name that gains no twin, or a listed name that gains one, fails here."""

import ast
import functools
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "collaborative_gan_sampling_tpu"
PORT_PKG = REPO / "collaborative_gan_sampling_torch"

# JAX name -> the port's name for it. Flax modules' ``__call__`` is
# ``forward`` on the port's ``nn.Module`` of the same class name (the rule
# in ``_port_twin``), so those are not listed one by one.
RENAMED = {
    "conv2d": "SameConv2d",  # a Flax Conv factory -> an nn.Module
    "deconv2d": "SameConvTranspose2d",
    "make_dcgan_pair": "GANBundle.init",
    "make_mlp_pair": "GANBundle.init",
    "init_inception_variables": "init_inception",
    "load_inception_variables": "load_inception",
    "params_from_torch_state_dict": "inception_from_torch_state_dict",
    # The port's Inception carries torchvision's module names, so the
    # torch -> Flax name map is the identity inside the state-dict loader.
    "conversion_layer_names": "inception_from_torch_state_dict",
    "create_shaping_state": "ShapingStep.init",
    "make_shaping_step": "ShapingStep",
    "sampling_g_vars": "sampling_g",
    "step_key": "step_generator",
    "split_for_batch": "philox_keys",
    "make_mesh": "make_group",
    "drs_accept_mask_pallas": "drs_accept_mask_philox",
    "drs_accept_mask_pallas_from_uniform": "drs_accept_mask_from_uniform",
    # bf16 mode; the f32 mode is fused_refine_conv28, a name both share.
    "fused_refine_conv28_v2": "fused_refine_conv28_bf16",
    "supports_conv_pallas_refine": "supports_conv_refine_kernel",
    "supports_pallas_refine": "supports_mlp_refine_kernel",
}

# Items of ROADMAP.md's "Not to port" list, each quoted as the list quotes it.
EXPORT_TF = "`sampling/export.py::export_tf_savedmodel`"
COMPILE_CACHE = "`utils/compile_cache.py`"
REFINE_S2D = "`ops/refine_s2d.py`"
S2D_LAYOUT = "space-to-depth layout"
GSPMD = "GSPMD helpers"

# JAX name -> the ROADMAP item that says why it has no twin.
NOT_TO_PORT = {
    "export_tf_savedmodel": EXPORT_TF,
    "enable_compile_cache": COMPILE_CACHE,
    **{n: REFINE_S2D for n in (
        "conv0_kernel_to_s2d", "deconv_kernel_to_s2d", "make_d_fwd_s2d",
        "make_draw_refine_s2d", "make_g_fwd_s2d", "make_refine_s2d",
        "supports_s2d_refine")},
    **{n: S2D_LAYOUT for n in (
        "space_to_depth", "depth_to_space", "conv_s2d_fwd",
        "conv_s2d_bwd_input", "d_forward_s2d", "d_input_grad_s2d",
        "refine_s2d_reference", "dlrelu", "s2d4", "d2s4")},
    **{n: GSPMD for n in (
        "batch_sharding", "replicated_sharding", "constrain_batch")},
}

# JAX modules with no port module of the same path: the Pallas files, whose
# kernels are CUDA sources under csrc/, and two "Not to port" items.
PALLAS_MODULES = {
    "ops.accept_pallas": ("drs_accept.cu",),
    "ops.conv_refine_pallas": ("conv_refine28.cu", "conv_refine28_bf16.cu"),
    "ops.refine_pallas": ("refine_mlp.cu",),
}
MODULES_NOT_TO_PORT = {"ops.refine_s2d": REFINE_S2D,
                       "utils.compile_cache": COMPILE_CACHE}


def _module_names(pkg: Path) -> set[str]:
    return {".".join(p.relative_to(pkg).with_suffix("").parts)
            for p in pkg.rglob("*.py")}


@functools.cache
def _surface(pkg: Path) -> frozenset[str]:
    """Public top-level functions and classes, and ``Class.method`` for the
    public methods (and ``__call__``) of public classes."""
    defs = (ast.FunctionDef, ast.AsyncFunctionDef)
    names = set()
    for path in pkg.rglob("*.py"):
        for node in ast.parse(path.read_text(), filename=str(path)).body:
            if not isinstance(node, (*defs, ast.ClassDef)) or \
                    node.name.startswith("_"):
                continue
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                names.update(
                    f"{node.name}.{m.name}" for m in node.body
                    if isinstance(m, defs)
                    and (not m.name.startswith("_") or m.name == "__call__"))
    return frozenset(names)


def _port_twin(name: str) -> str | None:
    if name.endswith(".__call__"):
        return name[:-len("__call__")] + "forward"
    return RENAMED.get(name)


@functools.cache
def _not_to_port_section() -> str:
    text = (REPO / "ROADMAP.md").read_text()
    start = text.index("**Not to port:**")
    end = re.compile(r"^\*\*", re.M).search(text, start + 2)
    return text[start:end.start() if end else len(text)]


def test_jax_names_without_twin_are_the_lists():
    missing = _surface(JAX_PKG) - _surface(PORT_PKG)
    flax_calls = {n for n in missing if n.endswith(".__call__")}
    listed = flax_calls | set(RENAMED) | set(NOT_TO_PORT)
    assert sorted(missing - listed) == [], "JAX names with no port twin"
    assert sorted(listed - missing) == [], "listed names that have a twin"
    assert "Config.to_json" in _surface(PORT_PKG)
    assert not set(RENAMED) & set(NOT_TO_PORT)


@pytest.mark.parametrize("name", sorted(
    set(RENAMED) | {n for n in _surface(JAX_PKG) - _surface(PORT_PKG)
                    if n.endswith(".__call__")}))
def test_renamed_twin_exists(name):
    assert name in _surface(JAX_PKG)
    assert _port_twin(name) in _surface(PORT_PKG)


@pytest.mark.parametrize("name", sorted(NOT_TO_PORT))
def test_not_to_port_is_in_roadmap(name):
    assert name in _surface(JAX_PKG)
    assert name not in _surface(PORT_PKG)
    assert NOT_TO_PORT[name] in _not_to_port_section()


def test_jax_modules_without_twin():
    missing = _module_names(JAX_PKG) - _module_names(PORT_PKG)
    assert missing == set(PALLAS_MODULES) | set(MODULES_NOT_TO_PORT)
    for sources in PALLAS_MODULES.values():
        for source in sources:
            assert (PORT_PKG / "csrc" / source).is_file()
    for item in MODULES_NOT_TO_PORT.values():
        assert item in _not_to_port_section()
