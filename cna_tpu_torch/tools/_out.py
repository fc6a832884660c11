"""Progress output gating, mirroring the reference's UX.

The reference's entire logging system is a stdout-or-devnull switch
(``_out.py:1-9``); diagnostic quantities (kurtosis trail, ridge sweep,
step counts) are part of the documented user experience, so the same
messages are emitted here through a tiny logger that also records them
structurally for tests and tracing.
"""

from __future__ import annotations

import sys


class Progress:
    """Prints progress lines when enabled; always records them."""

    def __init__(self, enabled: bool = False, stream=None):
        self.enabled = enabled
        self.stream = stream if stream is not None else sys.stdout
        self.lines: list[str] = []

    def __call__(self, *parts) -> None:
        msg = " ".join(str(p) for p in parts)
        self.lines.append(msg)
        if self.enabled:
            print(msg, file=self.stream)


def select_output(show_progress: bool = False) -> Progress:
    return Progress(enabled=bool(show_progress))
