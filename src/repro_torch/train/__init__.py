"""The training loop: train steps, restart and the straggler watchdog."""
