"""The LM substrate of the port: configuration, layers, parameters,
attention and the pattern-unit transformer (dense attention stacks)."""
