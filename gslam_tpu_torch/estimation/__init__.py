"""Robust estimation: batched RANSAC and P3P PnP with GN refinement."""
