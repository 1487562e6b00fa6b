"""Accepted samples of the completed collab calls over the window's seconds."""

from cardbench.readers import per_second


def read(r):
    return per_second(r, "accepted")
