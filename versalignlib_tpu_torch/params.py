"""Alignment scoring parameters.

The port's copy of ``versalignlib_tpu/params.py``: the analogue of the
reference's ``AlignmentParameters`` key->int plugin interface
(AlignmentParameters.h:11-22) and its concrete ``CustomParameters``
(CustomParameters.h:6-59), as a frozen, hashable dataclass. Scoring
parameters are the only state this system carries, so
:func:`params_from_reference` is how a configuration made for the JAX
package crosses into the port.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator


@dataclasses.dataclass(frozen=True)
class AlignmentParameters:
    """Linear / affine gap scoring configuration.

    Field names mirror the reference's parameter keys
    (CustomParameters.h:9-33): ``score_match``, ``score_mismatch``,
    ``score_gap_read``, ``score_gap_ref``.

    ``score_gap_read`` penalizes consuming a ref base against a gap in the
    read (pointer LEFT); ``score_gap_ref`` penalizes consuming a read base
    against a gap in the ref (pointer UP) — matching the reference recurrence
    (DefaultKernel.cpp:102-108).

    ``gap_open_*`` enable affine (Gotoh) gaps: total penalty for a gap of
    length L is ``gap_open + L * score_gap``. ``gap_open_* = 0`` (default) is
    exactly the reference's linear model.
    """

    score_match: int = 2
    score_mismatch: int = -1
    score_gap_read: int = -3
    score_gap_ref: int = -3
    gap_open_read: int = 0
    gap_open_ref: int = 0
    #: Optional S x S substitution matrix indexed by code. Code 0 is the
    #: padding sentinel: row 0 and column 0 must be all-zero. Stored as a
    #: tuple of tuples so the dataclass stays hashable.
    matrix: tuple | None = None

    def __post_init__(self) -> None:
        for name in ("score_gap_read", "score_gap_ref"):
            if getattr(self, name) > 0:
                raise ValueError(f"{name} must be <= 0, got {getattr(self, name)}")
        for name in ("gap_open_read", "gap_open_ref"):
            if getattr(self, name) > 0:
                raise ValueError(f"{name} must be <= 0, got {getattr(self, name)}")
        if self.matrix is not None:
            m = tuple(tuple(int(v) for v in row) for row in self.matrix)
            object.__setattr__(self, "matrix", m)
            s = len(m)
            if s < 2 or any(len(row) != s for row in m):
                raise ValueError(f"matrix must be square with S >= 2, got {m!r}")
            if any(m[0][j] != 0 for j in range(s)) or any(m[i][0] != 0 for i in range(s)):
                raise ValueError(
                    "matrix row 0 and column 0 must be zero (code 0 is the "
                    "padding sentinel; nonzero padding scores would break "
                    "tail-batch fill-up semantics)"
                )

    @property
    def affine(self) -> bool:
        return self.gap_open_read != 0 or self.gap_open_ref != 0

    @property
    def sub_size(self) -> int:
        """Alphabet size S of the substitution model (6 = reference table)."""
        return 6 if self.matrix is None else len(self.matrix)

    # -- reference-compatible key/value view (AlignmentParameters.h:14-15) --

    def param_int(self, key: str) -> int:
        if not self.has_key(key):
            raise KeyError(f"Unknown parameter key: {key}")
        return int(getattr(self, key))

    def has_key(self, key: str) -> bool:
        return key in {f.name for f in dataclasses.fields(self)}

    def keys(self) -> Iterator[str]:
        return iter(f.name for f in dataclasses.fields(self))

    def replace(self, **kw) -> "AlignmentParameters":
        return dataclasses.replace(self, **kw)


#: The reference driver's default scoring (CustomParameters.h:55-58).
DEFAULT_PARAMETERS = AlignmentParameters(
    score_match=2, score_mismatch=-1, score_gap_read=-3, score_gap_ref=-3
)


def params_from_reference(fields: dict[str, Any]) -> AlignmentParameters:
    """Build the port's parameters from ``dataclasses.asdict()`` of the JAX
    package's :class:`AlignmentParameters`.

    Values may be numpy scalars or plain ints, and ``matrix`` any nested
    sequence (or ``None``). Unknown or missing keys raise, so a field added on
    one side cannot be dropped silently on the other.
    """
    names = {f.name for f in dataclasses.fields(AlignmentParameters)}
    if set(fields) != names:
        raise ValueError(
            f"parameter fields differ: unexpected {sorted(set(fields) - names)}, "
            f"missing {sorted(names - set(fields))}")
    kw = {k: int(v) for k, v in fields.items() if k != "matrix"}
    matrix = fields["matrix"]
    if matrix is not None:
        matrix = tuple(tuple(int(v) for v in row) for row in matrix)
    return AlignmentParameters(matrix=matrix, **kw)
