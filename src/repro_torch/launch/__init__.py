"""The online Lloyd iteration as a pair of programs over pre-materialized
offline tensors (`kmeans_step`)."""
