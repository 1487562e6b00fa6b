"""The host's reads of the device per serving request (sampling/serve.py): counter host_syncs over the count of span cgs.serve.generate."""

from cardbench.span_readers import per_root


def read(r):
    return per_root("host_syncs", "cgs.serve.generate")
