"""Geometry: SO(3)/SE(3)/Sim(3) on quaternions, the lens models,
undistortion and rectification, image helpers, geodesy and IMU
preintegration."""
