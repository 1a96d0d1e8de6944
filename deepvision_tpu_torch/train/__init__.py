"""Training-side pieces of the port; this slice carries only the configs."""
