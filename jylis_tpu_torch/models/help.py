"""Command-help rendering on parse failure.

Reference behavior: help.pony:4-44 — every unparseable command gets an
error reply of "BADCOMMAND (could not parse command)" followed by either
the usage form of the named operation or the full operation table of the
data type; database.pony:28-39 renders the data-type list for an unknown
first word.
"""

from __future__ import annotations

BADCOMMAND_PREFIX = "BADCOMMAND (could not parse command)\n"


def respond_help(resp, help_text: str) -> None:
    resp.err(BADCOMMAND_PREFIX + help_text.rstrip())


class RepoHelp:
    """Operation table for one data type; renders per-op usage or the full
    table (help.pony:13-44)."""

    def __init__(self, datatype: str, commands: dict[str, str]):
        self.datatype = datatype
        self.commands = commands

    def render(self, cmd_after_type: list[bytes]) -> str:
        op = cmd_after_type[0].decode("utf-8", "replace") if cmd_after_type else None
        if op is not None and op in self.commands:
            return (
                "This operation expects the arguments in the following form:\n"
                f"{self.datatype} {op} {self.commands[op]}"
            )
        lines = [
            f"{self.datatype} {o} {args}" for o, args in self.commands.items()
        ]
        return (
            "The following are valid operations for this data type:\n"
            + "\n".join(lines)
        )


class LeafHelp:
    """Fixed help text (the SYSTEM repo's style, repo_system.pony:6-11)."""

    def __init__(self, text: str):
        self.text = text

    def render(self, cmd_after_type: list[bytes]) -> str:
        return self.text


DATATYPE_HELP = """\
The first word of each command must be a data type.
The following are valid data types (case sensitive):
  TREG    - Timestamped Register (Latest Write Wins)
  TLOG    - Timestamped Log (Retain Latest Entries)
  GCOUNT  - Grow-Only Counter
  PNCOUNT - Positive/Negative Counter
  UJSON   - Unordered JSON (Nested Observed-Remove Maps and Sets)
  TENSOR  - Tensor Register (Per-Coordinate Convergent Merges)
  MAP     - Composed Map (Fields Holding Any Registered Lattice)
  BCOUNT  - Bounded Counter (Replica-Local Escrow, value <= bound)
  SYSTEM  - (miscellaneous system-level operations)
"""
