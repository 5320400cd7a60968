"""Host-side string interning: the device does not hold strings.

An own copy of ``crdt_tpu.utils.intern`` (the port imports nothing of the
JAX package).  The reference's keys and values are Go strings
(map[string]string, the reference's main.go:19-21); device-side they
become dense int32 ids.  Values additionally carry the reference's
numeric/non-numeric distinction: `strconv.Atoi` success decides
counter-vs-LWW semantics per value (main.go:87-96), mirrored here by
`parse_go_int`.
"""
from __future__ import annotations

import re
from typing import Optional, Tuple

# Go's strconv.Atoi: optional sign, decimal digits only (no '_', no
# whitespace), must fit the platform int.  Device payloads are int32, so we
# additionally bound to int32 (larger values are treated as non-numeric —
# a documented divergence; the oracle is bounds-free Python).
_GO_INT = re.compile(r"^[+-]?[0-9]+$")
INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1


def parse_go_int(s: str) -> Optional[int]:
    """Return the integer value if `s` parses the way Go's Atoi does (and
    fits int32), else None."""
    if not _GO_INT.match(s):
        return None
    v = int(s)
    if not (INT32_MIN <= v <= INT32_MAX):
        return None
    return v


class Interner:
    """Bidirectional string ↔ dense int32 id table (insertion-ordered)."""

    def __init__(self):
        self._to_id: dict[str, int] = {}
        self._from_id: list[str] = []

    def intern(self, s: str) -> int:
        i = self._to_id.get(s)
        if i is None:
            i = len(self._from_id)
            self._to_id[s] = i
            self._from_id.append(s)
        return i

    def lookup(self, i: int) -> str:
        return self._from_id[i]

    def __contains__(self, s: str) -> bool:
        return s in self._to_id

    def items(self):
        """(string, id) pairs in insertion (= id) order."""
        return self._to_id.items()

    def __len__(self) -> int:
        return len(self._from_id)


def encode_value(s: str, values: Interner) -> Tuple[int, int, bool]:
    """Encode a reference value string as (val, payload, is_num): the numeric
    delta (0 if non-numeric), the interned id of the RAW string (always —
    the reference seeds newest values verbatim, main.go:82-85, so "007" must
    survive as "007" until an addition canonicalizes it), and the Atoi flag."""
    payload = values.intern(s)
    v = parse_go_int(s)
    if v is not None:
        return v, payload, True
    return 0, payload, False
