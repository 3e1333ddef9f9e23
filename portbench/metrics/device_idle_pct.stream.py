"""100 (1 - device busy / window) over the traced window, the busy time
the union of every device operation's interval."""

from portbench.harness.readers import idle_pct as read  # noqa: F401
