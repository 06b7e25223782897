"""Point warps between the images of a pair."""
