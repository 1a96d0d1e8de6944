"""Host data of the port: the synthetic set, batching and the device feed."""
