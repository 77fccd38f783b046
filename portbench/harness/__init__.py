"""The yardstick: the manifest, the traffic generator, the closed loop,
the trace reduction and the comparison that decides ``correct``."""
