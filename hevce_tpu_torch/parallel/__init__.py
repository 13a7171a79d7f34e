"""Batched entry points of the port: the bit-exact lockstep engine."""
