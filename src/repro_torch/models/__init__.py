"""Model substrate of the port (dense decoder stacks and the VLM
projector), in the reference's parameter layouts."""
