"""The LM substrate's models: layers (attention, MLP, sort-based MoE),
recurrences (RWKV6, RG-LRU), assembly and loss (`lm`), and parameter trees
(`tree`). Plain functions on nested dicts of tensors, as the JAX package's."""
