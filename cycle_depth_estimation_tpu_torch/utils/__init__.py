"""Host utilities of the port: weights, images, the HTML gallery."""
