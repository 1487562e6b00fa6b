"""The faults that ``imagenet64.collab_cond`` (entry ``collab_cond``) can
have, each planted in the port with pytest's ``monkeypatch``: the five of
an unconditional collab cell (``test_cardbench_faults.py``), written here
for a conditional D, which takes the labels of each batch, and three that
only a conditional model has. ``broken_limits`` says which limits a fault
breaks. Used at a tiny size on the CPU (``tests/test_torch_cardbench_cond.py``)
and at the cell's own size on the card (``test_cardbench_cond_card.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from collaborative_gan_sampling_torch.data.images import ImageDataset
from collaborative_gan_sampling_torch.models import GANBundle
from collaborative_gan_sampling_torch.models.dcgan import DCGANDiscriminator
from collaborative_gan_sampling_torch.sampling import collab, refine
from collaborative_gan_sampling_torch.training.shaping import ShapingStep


def unchanged_state(m):
    """Shaping computes its loss and leaves D as it was."""
    def step(self, state, x_real, x_refined, labels_r=None, labels_f=None,
             *args, **kwargs):
        with torch.no_grad():
            lr = self.bundle.discriminate(state.d, x_real, labels_r,
                                          train=False)
            lf = self.bundle.discriminate(state.d, x_refined, labels_f,
                                          train=False)
        return state, F.softplus(-lr).mean() + F.softplus(lf).mean()
    m.setattr(ShapingStep, "__call__", step)


def half_batch_shaping(m):
    original = ShapingStep.__call__

    def step(self, state, x_real, x_refined, labels_r=None, labels_f=None,
             *args, **kwargs):
        h = x_real.shape[0] // 2
        return original(self, state, x_real[:h], x_refined[:h],
                        labels_r[:h], labels_f[:h], *args, **kwargs)
    m.setattr(ShapingStep, "__call__", step)


def half_batch_refined(m):
    original = refine.make_refine_fn

    def make(bundle, cfg, *args, **kwargs):
        fn = original(bundle, cfg, *args, **kwargs)

        def half(d, x0, labels=None, *a, **k):
            n = x0.shape[0] // 2
            x, aux = fn(d, x0[:n], labels[:n], *a, **k)
            with torch.no_grad():
                logits = bundle.discriminate(d, x0[n:], labels[n:],
                                             train=False)
            return (torch.cat([x, x0[n:]]),
                    {"logits": torch.cat([aux["logits"], logits])})
        return half
    m.setattr(refine, "make_refine_fn", make)


def altered_sample(m):
    original = refine.make_draw_refine_fn

    def make(*args, **kwargs):
        fn = original(*args, **kwargs)

        def altered(*a, **k):
            x, labels, logits = fn(*a, **k)
            x = x.clone()
            x[0, 0, 0, 0] += 0.5
            return x, labels, logits
        return altered
    m.setattr(refine, "make_draw_refine_fn", make)
    m.setattr(collab, "make_draw_refine_fn", make)


def altered_accept(m):
    original = collab.drs_accept_mask
    m.setattr(collab, "drs_accept_mask", lambda *a, **k: ~original(*a, **k))


def projection_dropped(m):
    """D's logit without the projection term <embed(y), feat>."""
    original = DCGANDiscriminator.forward

    def no_projection(self, x, labels=None):
        saved = self.num_classes
        self.num_classes = 0
        try:
            return original(self, x)
        finally:
            self.num_classes = saved
    m.setattr(DCGANDiscriminator, "forward", no_projection)


def real_labels_shuffled(m):
    """Shaping's real batch paired with another row's label."""
    original = ImageDataset.batch_by_labels

    def shuffled(self, generator, labels):
        x, lab = original(self, generator, labels)
        return x, lab.flip(0)
    m.setattr(ImageDataset, "batch_by_labels", shuffled)


def labels_shifted(m):
    """Every drawn label one class on."""
    original = GANBundle.sample_labels

    def shifted(self, generator, n):
        labels = original(self, generator, n)
        return None if labels is None else (labels + 1) % self.num_classes
    m.setattr(GANBundle, "sample_labels", shifted)


FAULTS = [unchanged_state, half_batch_shaping, half_batch_refined,
          altered_sample, altered_accept, projection_dropped,
          real_labels_shuffled, labels_shifted]
IDS = [f.__name__ for f in FAULTS]


def broken_limits(clean: dict, faulty: dict) -> set:
    """The limits that the faulty run's check breaks and the clean run's
    keeps."""
    return {k for k, row in faulty.items()
            if row["value"] > row["limit"]
            and clean[k]["value"] <= clean[k]["limit"]}
