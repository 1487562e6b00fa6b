"""D's eval-mode epilogue kernels per collab call (ops/d_epilogue.py: cgs::d_epilogue_bf16 and its VJP, every forward of D in eval mode and every VJP of the autograd refinement, inside its CUDA graph included): counter d_epilogue_kernels over the count of span cgs.collab.call. None where the store holds no such counter, as under a program without it."""

from cardbench.span_readers import _summary, per_root


def read(r):
    if "d_epilogue_kernels" not in _summary()["counters"]:
        return None
    return per_root("d_epilogue_kernels", "cgs.collab.call")
