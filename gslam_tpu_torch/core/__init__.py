"""Geometry: SO(3)/SE(3) on quaternions and the pinhole camera."""
