"""Calibration's share of a serving request (the burn-in M, sampling/serve.py + sampling/rejection.py): span cgs.serve.calibrate over cgs.serve.generate."""

from cardbench.span_readers import share_pct


def read(r):
    return share_pct(("cgs.serve.calibrate",), "cgs.serve.generate")
