"""Tiny sizes for the harness's CPU tests (``manifest.resize``)."""
import pytest

TPCH_TINY = {"dbgen": {"orders": 4000, "customers": 600, "suppliers": 40, "parts": 800},
             "tables": {"lineitem": 16000, "orders": 4000, "customer": 600, "supplier": 40}}
Q1FRAME_TINY = {"dbgen": {"orders": 1500}, "tables": {"lineitem": 6000}}
TINY = {"tpch_sf30": TPCH_TINY, "q1frame_sf30": Q1FRAME_TINY}


@pytest.fixture
def tiny():
    return TINY
