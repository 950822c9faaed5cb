# Model families: the unified LM (dense family ported so far) and the
# converter from the reference package's parameter tree.
