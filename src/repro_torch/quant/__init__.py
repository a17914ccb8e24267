"""Quantized streaming inference: post-training calibration to int8, the
int32 reference model and the accuracy measures of the int8 path."""
