"""Hand model and forward kinematics."""
