"""Operations and bytes counted from the model's shapes, never from the
program's packs or launches: a later change of layout or of kernels leaves
these counts as they are."""
