"""The shaping real batch's draw (data/images.py ImageDataset.batch_by_labels via sampling/collab.py: the class table's gather and the normalisation) as a share of a collab call: span cgs.collab.real_batch over cgs.collab.call. None where the store holds no such span, as under a program without it."""

from cardbench.span_readers import _summary, share_pct

SPAN = "cgs.collab.real_batch"


def read(r):
    if SPAN not in _summary()["spans"]:
        return None
    return share_pct((SPAN,), "cgs.collab.call")
