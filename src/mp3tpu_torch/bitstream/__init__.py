"""Copy of mp3tpu.bitstream, kept in the port so that it imports nothing of
the JAX package; the code is the same."""
