"""The plain reference: plain PyTorch forwards, detection, matching and
geometry that decide `correct`. It imports nothing of the port and takes
nothing the port made: weights are read from the npz files, everything
else is worked out from the images, geometry and seeds."""
