"""Geometry: affine transforms, camera models, crop cameras."""
