"""Figures: the 2D overview, refinement trajectories, the teaser GIF and
image grids.

Counterpart of ``collaborative_gan_sampling_tpu/viz/plots.py``. The arrays
are computed apart from the drawing: ``_grid_fields`` evaluates D's logits
and the refinement field -dl/dx on a grid in one call on the model's
device, and the drawing functions take small host arrays. matplotlib (its
Agg backend: the figures are files, never windows) is imported inside the
drawing functions only, so the arrays need no matplotlib.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from collaborative_gan_sampling_torch.sampling.refine import (
    refine_loss_per_sample,
)


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _host(x: Any) -> np.ndarray:
    """A host array; a float tensor (bf16 included) as float32."""
    if isinstance(x, torch.Tensor):
        if x.is_floating_point():
            x = x.float()
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _fields(bundle, d, pts: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(logits, -grad) of D at ``pts`` (N, 2): the refinement moves along
    -grad of the summed ``ns`` loss."""
    with torch.enable_grad():
        x = pts.detach().requires_grad_(True)
        logits = bundle.discriminate(d, x, train=False)
        (grad,) = torch.autograd.grad(refine_loss_per_sample(logits).sum(),
                                      x)
    return logits.detach(), -grad


def _grid_fields(bundle, d, lim: float, n: int = 40):
    """D logits and the refinement gradient field on an (n, n) grid over
    [-lim, lim]^2, computed on the model's device in one call: (xx, yy,
    logits (n, n), vec (n, n, 2)) as host arrays."""
    xs = torch.linspace(-lim, lim, n, device=bundle.device)
    yy, xx = torch.meshgrid(xs, xs, indexing="ij")
    pts = torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=1)
    logits, vec = _fields(bundle, d, pts)
    return (_host(xx), _host(yy), _host(logits).reshape(n, n),
            _host(vec).reshape(n, n, 2))


def plot_2d_overview(path: str, bundle, d, spec, x_real: Any, x_gen: Any,
                     x_refined: Any | None = None, lim: float = 3.0,
                     title: str = "") -> str:
    """Scatter, decision surface, quiver and density: the 4-panel
    overview."""
    plt = _pyplot()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    x_real = _host(x_real)[:2000]
    x_gen = _host(x_gen)[:2000]
    means = _host(spec.means)
    xx, yy, surface, vec = _grid_fields(bundle, d, lim)

    fig, axes = plt.subplots(1, 4, figsize=(22, 5))

    ax = axes[0]
    ax.scatter(x_real[:, 0], x_real[:, 1], s=4, alpha=0.4, label="real",
               color="tab:blue")
    ax.scatter(x_gen[:, 0], x_gen[:, 1], s=4, alpha=0.4, label="generated",
               color="tab:orange")
    if x_refined is not None:
        x_refined = _host(x_refined)[:2000]
        ax.scatter(x_refined[:, 0], x_refined[:, 1], s=4, alpha=0.4,
                   label="refined", color="tab:green")
    ax.legend(markerscale=3)
    ax.set_title("samples")

    ax = axes[1]
    cs = ax.contourf(xx, yy, surface, levels=30, cmap="RdBu_r")
    fig.colorbar(cs, ax=ax)
    ax.scatter(means[:, 0], means[:, 1], marker="*", s=120, color="k")
    ax.set_title("D decision surface (logit)")

    ax = axes[2]
    skip = 2
    u, v = vec[::skip, ::skip, 0], vec[::skip, ::skip, 1]
    mag = np.hypot(u, v)
    # Arrows coloured by magnitude, their length capped at the 90th
    # percentile so that a few large gradients do not drown the field.
    cap = np.percentile(mag, 90) + 1e-12
    scale = np.minimum(mag, cap) / (mag + 1e-12)
    ax.quiver(xx[::skip, ::skip], yy[::skip, ::skip], u * scale, v * scale,
              mag, cmap="viridis", angles="xy")
    ax.scatter(means[:, 0], means[:, 1], marker="*", s=120, color="r")
    ax.set_title("refinement field  -dl/dx")

    ax = axes[3]
    pool = x_refined if x_refined is not None else x_gen
    h = ax.hist2d(pool[:, 0], pool[:, 1], bins=60,
                  range=[[-lim, lim], [-lim, lim]], cmap="magma")
    fig.colorbar(h[3], ax=ax)
    ax.set_title("sample density (KDE-style)")

    for ax in axes:
        ax.set_xlim(-lim, lim)
        ax.set_ylim(-lim, lim)
        ax.set_aspect("equal")
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_refinement_trajectories(path: str, traj: Any, spec=None,
                                 lim: float = 3.0,
                                 max_traj: int = 64) -> str:
    """The teaser figure: samples flowing along D's gradient field.
    ``traj`` is the (K+1, B, 2) trajectory of ``make_refine_fn(...,
    return_trajectory=True)``."""
    plt = _pyplot()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    traj = _host(traj)[:, :max_traj]
    fig, ax = plt.subplots(figsize=(6, 6))
    for b in range(traj.shape[1]):
        ax.plot(traj[:, b, 0], traj[:, b, 1], lw=0.7, alpha=0.5,
                color="tab:gray")
    ax.scatter(traj[0, :, 0], traj[0, :, 1], s=14, color="tab:orange",
               label="start", zorder=3)
    ax.scatter(traj[-1, :, 0], traj[-1, :, 1], s=14, color="tab:green",
               label="refined", zorder=3)
    if spec is not None:
        means = _host(spec.means)
        ax.scatter(means[:, 0], means[:, 1], marker="*", s=140, color="k",
                   label="modes", zorder=4)
    ax.set_xlim(-lim, lim)
    ax.set_ylim(-lim, lim)
    ax.set_aspect("equal")
    ax.legend()
    ax.set_title("refinement trajectories")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def save_teaser_gif(path: str, traj: Any, spec=None, lim: float = 3.0,
                    max_traj: int = 256, fps: int = 8) -> str:
    """The animated teaser: samples flowing along D's gradient field, one
    frame per refinement step."""
    plt = _pyplot()
    from matplotlib import animation

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    traj = _host(traj)[:, :max_traj]
    fig, ax = plt.subplots(figsize=(5, 5))
    if spec is not None:
        means = _host(spec.means)
        ax.scatter(means[:, 0], means[:, 1], marker="*", s=140, color="k",
                   zorder=4)
    scat = ax.scatter(traj[0, :, 0], traj[0, :, 1], s=10,
                      color="tab:orange", zorder=3)
    ax.set_xlim(-lim, lim)
    ax.set_ylim(-lim, lim)
    ax.set_aspect("equal")
    title = ax.set_title("refinement step 0")

    def update(k):
        scat.set_offsets(traj[k])
        frac = k / max(1, len(traj) - 1)
        scat.set_color((1 - frac) * np.array([1.0, 0.5, 0.05])
                       + frac * np.array([0.17, 0.63, 0.17]))
        title.set_text(f"refinement step {k}")
        return scat, title

    anim = animation.FuncAnimation(fig, update, frames=len(traj))
    anim.save(path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return path


def save_image_grid(path: str, images: Any, nrow: int = 8) -> str:
    """Tile (N, H, W, C) images in [-1, 1] into one png montage, on an
    absolute intensity scale (grids of different steps compare)."""
    plt = _pyplot()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    imgs = np.clip((_host(images).astype(np.float32) + 1.0) * 127.5, 0,
                   255).astype(np.uint8)
    n, h, w, c = imgs.shape
    ncol = (n + nrow - 1) // nrow
    grid = np.zeros((ncol * h, nrow * w, c), np.uint8)
    for i in range(n):
        r, col = divmod(i, nrow)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = imgs[i]
    if c == 1:
        plt.imsave(path, grid[..., 0], cmap="gray", vmin=0, vmax=255)
    else:
        plt.imsave(path, grid)
    return path
