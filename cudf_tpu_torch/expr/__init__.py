"""Expressions and the logical-plan IR with its in-memory executor."""
