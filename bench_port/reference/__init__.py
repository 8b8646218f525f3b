"""Plain PyTorch reference of what a cell serves: the binarizer's encode,
SDC scoring, and the exact searches of each index kind. It imports
nothing of the port and takes nothing the port has made."""
