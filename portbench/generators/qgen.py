"""TPC-H's substitution parameters (qgen), drawn for each execution of a
query: the specification's sections 2.4.1.3, 2.4.3.3, 2.4.5.3 and
2.4.6.3 (v3.0.1). A parameter set is a tuple, so that it names an
answer."""
from __future__ import annotations

import numpy as np

from portbench.generators.tpch import REGIONS, SEGMENTS


def q1(rng) -> tuple:
    """(DELTA,): days before 1998-12-01, 60 to 120."""
    return (int(rng.integers(60, 121)),)


def q3(rng) -> tuple:
    """(SEGMENT, DATE): a market segment, a day of March 1995."""
    return (SEGMENTS[int(rng.integers(len(SEGMENTS)))], f"1995-03-{int(rng.integers(1, 32)):02d}")


def q5(rng) -> tuple:
    """(REGION, year): a region, January 1st of 1993 to 1997."""
    return (REGIONS[int(rng.integers(len(REGIONS)))], int(rng.integers(1993, 1998)))


def q6(rng) -> tuple:
    """(year, DISCOUNT in hundredths, QUANTITY): January 1st of 1993 to
    1997, 0.02 to 0.09, 24 or 25."""
    return (int(rng.integers(1993, 1998)), int(rng.integers(2, 10)), int(rng.integers(24, 26)))


PARAMETERS = {"q1": q1, "q3": q3, "q5": q5, "q6": q6}


def q1_cutoff(delta: int) -> np.datetime64:
    return np.datetime64("1998-12-01", "ns") - np.timedelta64(delta, "D")
