"""Planning tools: the roofline of a step counted on meta tensors."""
