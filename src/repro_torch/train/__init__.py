"""Training: the step, the loop with checkpoint/restart, checkpoints and
straggler detection (port of ``repro/train``)."""
