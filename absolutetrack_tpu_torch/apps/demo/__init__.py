"""The live stereo demo (port of ``absolutetrack_tpu/apps/demo/``): 2D
keypoints per view (MediaPipe, or a replay of given keypoints) drive the
crops of the 3D tracker, whose world landmarks go to Unity over UDP."""
