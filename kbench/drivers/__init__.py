"""Drivers of the traffic mixes: ``kbench/traffic/<mix>.json`` names its
driver module here by its ``driver`` key."""
