"""Refined samples completed in the window over its seconds."""

from cardbench.readers import per_second


def read(r):
    return per_second(r, "refined")
