"""The port's offline tools (counterparts of the JAX package's ``tools/``),
run as ``python -m raw_ngp_torch.tools.<name>``; each ``main(argv)`` takes
the JAX tool's arguments. None imports cv2, imageio, PIL or JAX."""
