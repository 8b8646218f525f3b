"""DLRM dot interaction: the strictly lower triangle of each example's Gram matrix."""
