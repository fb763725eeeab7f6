"""Diagnostic scripts for the port's kernels; nothing here is on a training path."""
