"""Host-side dataset IO of the port (counterpart of ``rcvpose_tpu.data``)."""
