"""Durability: atomic publishing and the LM substrate's keep-N
`CheckpointStore` (`store`), resumable fit checkpoints
(`fit`) and the scoring service's response journal (`serve`). The files on
disk are the JAX package's: a checkpoint written by either package loads
in the other."""
