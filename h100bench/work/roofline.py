"""A kernel's share of its roofline over a profiled stretch: the least
time its calls could take on the H100 (operations over the peak rate or
bytes over the peak bandwidth, whichever is longer, summed over the
calls a batch makes, times the stretch's batches) over the device time
of the operations with the kernel's names."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

from . import kernels


def share(ctx: Dict, calls: Callable, works: Sequence[Callable],
          pick: Callable[[str], bool],
          entry: Optional[str] = None) -> Optional[float]:
    """The share in %, or None where the stretch ran none of the kernel's
    operations (or the entry is not ``entry``)."""
    st = ctx.get("stretch")
    if st is None or (entry and ctx["entry"] != entry):
        return None
    mix = ctx["mix"]
    cs = calls(ctx["model"], mix["batch"], mix["canvas"], mix["sampling"])
    device_s = st.device_time(pick)
    if not cs or device_s <= 0:
        return None
    bound_ms = sum(kernels.bound_ms(c, fn)[0] for c in cs for fn in works)
    return 100.0 * bound_ms * 1e-3 * st.batches / device_s

