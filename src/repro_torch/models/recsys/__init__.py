"""Recommendation models: DLRM (dlrm-rm2 serving forward)."""
