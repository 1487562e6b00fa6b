"""The hand kernels as ``torch.library`` custom ops, namespace ``cgs``.

Importing this module registers every op; a program that runs a
``torch.export`` artifact of the port (``sampling/export.py::load_sampler``)
imports it and nothing of the models, so the artifact's kernel nodes
resolve. Each op is defined beside its kernel's wrapper:

=================================  ==========================  ===========================
op                                 kernel                      TPU kernel it replaces
=================================  ==========================  ===========================
``cgs::drs_accept_philox``         ``csrc/drs_accept.cu``      ``accept_pallas.py:83``
``cgs::drs_accept_from_uniform``   ``csrc/drs_accept.cu``      ``accept_pallas.py:115``
``cgs::conv_refine28``             ``csrc/conv_refine28.cu``   ``conv_refine_pallas.py:275``
``cgs::conv_refine28_bf16``        ``csrc/conv_refine28_bf16.cu``  ``conv_refine_pallas.py:483``
``cgs::refine_mlp``                ``csrc/refine_mlp.cu``      ``refine_pallas.py:109``
=================================  ==========================  ===========================

Each has a CUDA implementation (the kernel's launch, counted on its
wrapper's ``launches``), a CPU implementation (the plain version) and a
fake implementation (the output shapes); no other device has one. No op
writes its inputs.
"""

from __future__ import annotations

from collaborative_gan_sampling_torch.ops import (  # noqa: F401
    accept,
    conv_refine,
    refine_mlp,
)

OPS = ("drs_accept_philox", "drs_accept_from_uniform", "conv_refine28",
       "conv_refine28_bf16", "refine_mlp")
