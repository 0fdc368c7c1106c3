"""Attention ops: the hand-written Hopper flash kernel and the plain path."""
