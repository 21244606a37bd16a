"""Multi-device scale-out on ``torch.distributed``, one process per device:
the row-sharded map 5-NN, the distributed Schur pose-graph solve, one-map
multi-rank SLAM and independent SLAM lanes (the port of
``alego_tpu.parallel``)."""
