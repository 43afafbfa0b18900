"""Check `sweeps`: each tapped sweep recomputed by the reference
(`vbench.check`, `vbench.tap`). A cell whose file names no check takes
this one.

A check module gives the harness:

  Tap(rng)                 the tap: `install()`, `uninstall()`, `records`,
                           `request` (armed while not None) and `armed`,
                           the indices of the window's requests it arms,
                           drawn with `rng` (the run's check seed)
  check(cell, inputs, tap, products, control=None)
                           the numbers (with `control`, one of `CONTROLS`,
                           the control's)
  CONTROLS                 the names of its controls
  LIMITS                   the names of the numbers a cell's file gives
                           a limit (`harness.load_cell` refuses a cell
                           whose `limits` name others); the rest are
                           exact, limit 0
  verdict(numbers, limits) (every number within its limit, the table)
  unread(products)         the numbers when the output could not be read
  context(tap)             what the readers' `Context` takes from the tap

Here REQUESTS requests drawn among the window's first FIRST are armed,
and `check.check` follows their sweeps; the control is the reference in
bfloat16.
"""

from vbench import check as sweep_check
from vbench.tap import SweepTap

verdict = sweep_check.verdict
#: The sample: REQUESTS requests drawn from the run's seed among the
#: window's first FIRST.
FIRST = 8
REQUESTS = 1
CONTROLS = ("bfloat16",)
LIMITS = frozenset({"count_dev"})


class Tap(SweepTap):
    def __init__(self, rng):
        super().__init__()
        self.armed = set(rng.sample(range(FIRST), REQUESTS))


def check(cell, inputs, tap, products, control=None) -> dict:  # noqa: ARG001
    return sweep_check.check(tap.records, products, cell.mix["request"]["sweeps"],
                             control=control is not None)


def unread(products) -> dict:
    numbers = dict.fromkeys(("count_dev",) + sweep_check.EXACT, 0.0)
    numbers["unchecked"] = float(len(products))
    return numbers


def context(tap) -> dict:
    """The alias route's MH rounds, where the tapped sweeps ran it."""
    return {"alias_rounds": max((r.rounds for r in tap.records if r.entry == "alias"),
                                default=0)}
