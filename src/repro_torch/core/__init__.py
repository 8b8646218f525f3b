"""Recurrent binarization (eval mode) and code arithmetic."""
