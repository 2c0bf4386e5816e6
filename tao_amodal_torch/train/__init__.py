"""Training: the detector + expander loss, the optimizers and schedules,
the single-device train step, the trainer loop with checkpoint/resume
and fail-safe retry, and PasteNOcclude."""
