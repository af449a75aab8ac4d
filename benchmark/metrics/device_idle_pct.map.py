"""The share of the traced window in which no kernel, copy or memset ran
on the card."""

from vbench.trace import idle_pct as read  # noqa: F401
