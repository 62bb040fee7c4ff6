"""Utilities (port of ``ocflow_tpu/utils``): checkpoints, the step timer,
flow colouring, the validation panels and a PNG writer."""
