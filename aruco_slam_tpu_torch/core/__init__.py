"""Quaternion and pinhole-camera math on tensors."""
