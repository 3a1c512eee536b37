"""Model families of the port (counterpart of ``paddle_tpu/models``)."""
