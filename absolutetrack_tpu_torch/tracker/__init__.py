"""Crop-slot generation and the per-frame tracker."""
