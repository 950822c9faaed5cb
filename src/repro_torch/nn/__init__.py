# Neural-net primitives on tensors: layers and attention.
