"""Measurement tools of the port: the count-kernel lab and device peaks."""
