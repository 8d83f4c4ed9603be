"""Least times of the port's kernels, from the operations and bytes the
inputs need (each input byte read once, each output byte written once),
against the card's peaks (`peaks`)."""
