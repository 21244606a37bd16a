"""The benchmark's plain reference: the SLAM frame step and the hoisted loop
attempt in plain PyTorch, float32 with TF32 off, independent of the program.

Most modules are frozen copies of the port's plain math (each names its
origin in its first line), with their imports made local.  Three are written
here instead of copied, so that the reference shares no code path with the
program's kernels and stays cheap enough to run after every window:

- ``search``: the exact k-NN / 1-NN by difference-squares, ties to the lower
  index, over large ref chunks;
- ``ccl``: connected components by label propagation with pointer jumping
  (component-minimum flat indices, the labels the program's CCL defines);
- ``solve``: a straightforward Gauss-Newton whose 6x6 algebra runs in float64
  on the host, stopping as soon as the step falls to its tolerance.

``pipeline`` holds the frame step (de-skew off) and the loop attempt.  This
package imports torch, numpy and the standard library only: nothing of the
program and nothing of JAX.
"""
