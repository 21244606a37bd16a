"""Host-side utilities of the port: the synthetic renderer, trajectory
metrics, rosbag and point-cloud IO, the HTML viewer and timers (numpy-only
copies of the reference's)."""
