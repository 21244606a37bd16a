"""Pipeline stages of the port: image projection, laser odometry, laser
mapping, the keyframe pose graph and the full frame step."""
