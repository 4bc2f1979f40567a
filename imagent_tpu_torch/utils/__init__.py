"""Metrics, logging and the TensorBoard event writer."""
