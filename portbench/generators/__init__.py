"""Data generators that configurations share, in plain torch."""
