# Model families: the unified LM (every registered family), the step
# functions (training, prefill, serving) and the converter from the
# reference package's parameter and optimizer trees.
