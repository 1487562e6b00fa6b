"""Launch counters of program kernels that a checkout's program may lack.

``trace.counter`` reads ``<module>:<attr>``'s ``launches`` for each
``kernels/*.json``. A spec whose kernel is newer than a program it traces
names a ``Launches`` here instead of the program's wrapper: it reads the
wrapper's ``launches``, and 0 where the program has no such module or
wrapper, so that the trace of such a program asks no record of the
kernel."""

from __future__ import annotations

import importlib


class Launches:
    """``launches`` of ``<module>.<attr>``, 0 where the program lacks it."""

    def __init__(self, module: str, attr: str):
        self.module, self.attr = module, attr

    @property
    def launches(self) -> int:
        try:
            mod = importlib.import_module(self.module)
        except ModuleNotFoundError as e:
            if e.name != self.module:
                raise
            return 0
        wrapper = getattr(mod, self.attr, None)
        return 0 if wrapper is None else wrapper.launches


d_epilogue = Launches("collaborative_gan_sampling_torch.ops.d_epilogue",
                      "d_epilogue")
