"""Unit <-> printable-unicode mapping.

The port's copy of speech_resynth_tpu/text/units.py: unit ids map to
printable characters, skipping the C0 controls and space (0-32), and DEL,
the C1 controls and NBSP (127-160).
"""

from __future__ import annotations

from typing import List, Sequence


def shift_unit(unit: int) -> int:
    """unit id -> unicode code point."""
    if unit < 94:
        return unit + 33  # printable ASCII 33..126
    return unit + 67  # 161..


def unshift_unit(code_point: int) -> int:
    """code point -> unit id (the inverse of ``shift_unit``)."""
    if 33 <= code_point <= 126:
        return code_point - 33
    if code_point >= 161:
        return code_point - 67
    raise ValueError(f"code point {code_point} is not a shifted unit")


def units_to_unicode(units: Sequence[int]) -> str:
    """unit id sequence -> printable string."""
    return "".join(chr(shift_unit(int(u))) for u in units)


def unicode_to_units(s: str) -> List[int]:
    """printable string -> unit id sequence."""
    return [unshift_unit(ord(c)) for c in s]
