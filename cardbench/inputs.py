"""The benchmark's inputs, made from ``--seed`` on the device: seed weights of
the DCGAN pair, procedural "real" images for D's shaping, and the draws of
the real batches. Both the program and the reference get these same
tensors.

Seed weights. Each conv, transposed-conv and dense kernel is N(0, gain /
fan_in), with gain 2 before a relu, 2 / (1 + 0.2**2) before an lrelu and 1
before tanh or the logit; biases 0; BatchNorm scale 1, shift 0, running
mean 0 and variance 1. A trained pair's BatchNorm keeps its activations
near unit scale; at the DCGAN init (N(0, 0.02)) with untrained running
averages G's images would lie within +-0.02 and D's logits near 0, which
no deployment serves. All kernels come from one ``randn`` on the card.
"""

from __future__ import annotations

import hashlib

import torch

from cardbench.reference.dcgan import num_stages

LRELU_GAIN = 2.0 / (1.0 + 0.2 ** 2)


def subseed(seed: int, *tags) -> int:
    """A 63-bit seed for one use of ``--seed`` (the run's weights, images,
    call i, request i, ...), the same for the same tags."""
    text = "/".join(str(t) for t in (seed,) + tags)
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") >> 1


def generator(seed: int, device: torch.device, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, *tags))


def _bn(name: str, ch: int) -> list:
    return [(f"{name}.weight", (ch,), "one"), (f"{name}.bias", (ch,), "zero"),
            (f"{name}.running_mean", (ch,), "zero"),
            (f"{name}.running_var", (ch,), "one")]


def _layer(name, shape, fan_in, gain) -> list:
    return [(f"{name}.weight", shape, (gain / fan_in) ** 0.5),
            (f"{name}.bias", (shape[1] if "deconv" in name else shape[0],),
             "zero")]


def generator_layout(model: dict) -> list:
    """(name, shape, std or 'zero' / 'one') of every tensor of G."""
    size, c, base, z_dim = (model["image_size"], model["channels"],
                            model["g_base_filters"], model["z_dim"])
    n = num_stages(size)
    s0, ch0 = size // 2 ** n, base * 2 ** (n - 1)
    out = _layer("project", (s0 * s0 * ch0, z_dim), z_dim, 2.0)
    out += _bn("bn_project", ch0)
    ch_in = ch0
    for i in range(n - 1):
        ch = base * 2 ** (n - 2 - i)
        out += _layer(f"deconv{i}", (ch_in, ch, 5, 5), ch_in * 25 / 4, 2.0)
        out += _bn(f"bn{i}", ch)
        ch_in = ch
    out += _layer("deconv_out", (ch_in, c, 5, 5), ch_in * 25 / 4, 1.0)
    return out


def discriminator_layout(model: dict) -> list:
    """(name, shape, std or 'zero' / 'one') of every tensor of D."""
    size, c, base = model["image_size"], model["channels"], \
        model["d_base_filters"]
    n = num_stages(size)
    out = _layer("conv0", (base, c, 5, 5), c * 25, LRELU_GAIN)
    for i in range(1, n):
        cin, cout = base * 2 ** (i - 1), base * 2 ** i
        out += _layer(f"conv{i}", (cout, cin, 5, 5), cin * 25, LRELU_GAIN)
        out += _bn(f"bn{i}", cout)
    side = size // 2 ** n
    feat = side * side * base * 2 ** (n - 1)
    out += _layer("out", (1, feat), feat, 1.0)
    return out


def _fill(layout: list, flat: torch.Tensor, at: int, device) -> tuple:
    w = {}
    for name, shape, init in layout:
        if init == "zero":
            w[name] = torch.zeros(shape, device=device)
        elif init == "one":
            w[name] = torch.ones(shape, device=device)
        else:
            numel = torch.Size(shape).numel()
            w[name] = flat[at:at + numel].view(shape) * init
            at += numel
    return w, at


def seed_weights(model: dict, seed: int, device: torch.device
                 ) -> tuple[dict, dict]:
    """(G's tensors, D's tensors) as float32 on ``device``: every kernel
    from one N(0, 1) draw, scaled by its layer's std."""
    g_layout, d_layout = generator_layout(model), discriminator_layout(model)
    total = sum(torch.Size(s).numel() for _, s, i in g_layout + d_layout
                if not isinstance(i, str))
    flat = torch.randn(total, generator=generator(seed, device, "weights"),
                       device=device)
    gw, at = _fill(g_layout, flat, 0, device)
    dw, _ = _fill(d_layout, flat, at, device)
    return gw, dw


def procedural_images(n: int, model: dict, seed: int, device: torch.device,
                      bumps: int = 6, chunk: int = 2048) -> torch.Tensor:
    """n images (n, H, W, C) in [-1, 1]: per image, ``bumps`` Gaussian
    blobs of random centre, width (5% to 25% of the side) and per-channel
    amplitude, summed and put through tanh."""
    size, c = model["image_size"], model["channels"]
    gen = generator(seed, device, "images")
    axis = (torch.arange(size, device=device, dtype=torch.float32) + 0.5) / size
    yy, xx = axis.view(1, 1, size, 1), axis.view(1, 1, 1, size)
    out = torch.empty((n, size, size, c), device=device)
    for lo in range(0, n, chunk):
        m = min(chunk, n - lo)
        u = torch.rand((m, bumps, 3 + c), generator=gen, device=device)
        cy, cx = u[..., 0, None, None], u[..., 1, None, None]
        width = (0.05 + 0.2 * u[..., 2, None, None]) ** 2 * 2
        blob = torch.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / width)
        amp = 3.0 * u[..., 3:] - 1.5
        out[lo:lo + m] = torch.tanh(torch.einsum("mbhw,mbc->mhwc", blob, amp))
    return out


def real_batch(images: torch.Tensor, gen: torch.Generator, n: int
               ) -> torch.Tensor:
    """n real images drawn with replacement: one ``randint`` from gen."""
    idx = torch.randint(0, images.shape[0], (n,), generator=gen,
                        device=images.device)
    return images[idx]
