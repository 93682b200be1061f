"""Train / serve steps and the model-size arithmetic of the dry run."""
