"""Host utilities of the port: image IO and the metrics writer."""
