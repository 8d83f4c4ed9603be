"""Numpy fixtures: synthetic marker scenes and the frame renderer."""
