"""PSD matrix square roots for the Frechet distance.

Counterpart of ``collaborative_gan_sampling_tpu/ops/sqrtm.py``:

* ``sqrtm_newton_schulz``: the coupled Newton-Schulz iteration, all
  matmuls, on a matrix pre-scaled by its Frobenius norm (it converges for
  ``||A/c - I|| < 1``). Differentiable by autograd (FID-backprop);
* ``trace_sqrtm_product``: Tr((s1 s2)^(1/2)) by Newton-Schulz, with the
  jitter ``eps * tr(s1 s2) / n`` on the diagonal that keeps rank-deficient
  products inside the iteration's region;
* ``psd_sqrt_eigh`` and ``trace_sqrtm_product_eigh``: the robust path,
  ``torch.linalg.eigh`` / ``eigvalsh`` with negative eigenvalues clipped.

Everything runs in float32 on the device of its inputs. Callers on the card
turn TF32 off (``utils/precision.py``): these are float32 products.
"""

from __future__ import annotations

import torch


def sqrtm_newton_schulz(a: torch.Tensor, iters: int = 20) -> torch.Tensor:
    """Matrix square root of a PSD matrix ``a`` (n, n), float32."""
    n = a.shape[0]
    a = a.float()
    norm = torch.sqrt(torch.sum(a * a)) + 1e-12
    eye = torch.eye(n, dtype=torch.float32, device=a.device)
    y, z = a / norm, eye
    for _ in range(iters):
        t = 0.5 * (3.0 * eye - z @ y)
        y, z = y @ t, t @ z
    return y * torch.sqrt(norm)


def trace_sqrtm_product(s1: torch.Tensor, s2: torch.Tensor,
                        iters: int = 30, eps: float = 1e-6) -> torch.Tensor:
    """Tr((s1 @ s2)^(1/2)) for PSD s1, s2 by Newton-Schulz: the FID cross
    term. s1 @ s2 is similar to the PSD s1^(1/2) s2 s1^(1/2), so its root
    exists; the diagonal jitter ``eps`` times the mean diagonal of the
    product keeps a rank-deficient product convergent."""
    n = s1.shape[0]
    prod = s1 @ s2
    scale = torch.trace(prod) / n
    prod = prod + (eps * scale) * torch.eye(n, dtype=torch.float32,
                                            device=prod.device)
    return torch.trace(sqrtm_newton_schulz(prod, iters))


def psd_sqrt_eigh(s: torch.Tensor) -> torch.Tensor:
    """Symmetric PSD square root by eigh: symmetrised first, negative
    (noise) eigenvalues clipped to 0."""
    s = 0.5 * (s + s.T)
    d, u = torch.linalg.eigh(s)
    d = torch.sqrt(torch.clamp_min(d, 0.0))
    return (u * d[None, :]) @ u.T


def trace_sqrtm_product_eigh(s1: torch.Tensor, s2: torch.Tensor
                             ) -> torch.Tensor:
    """Tr((s1 s2)^(1/2)) as the sum of the square roots of the eigenvalues
    of A s2 A, A = s1^(1/2): s1 s2 is similar to it. Exact for PSD inputs
    of any rank; the default FID cross term."""
    a = psd_sqrt_eigh(s1.float())
    m = a @ s2.float() @ a
    m = 0.5 * (m + m.T)
    ev = torch.linalg.eigvalsh(m)
    return torch.sum(torch.sqrt(torch.clamp_min(ev, 0.0)))
