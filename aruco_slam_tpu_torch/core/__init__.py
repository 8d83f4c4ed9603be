"""Quaternion, SE(3) and pinhole-camera math on tensors."""
