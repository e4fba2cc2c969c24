"""The pieces of the reference's distribution substrate that the train
loop uses on one card: topology-free checkpoints, the straggler tracker
and the recovery log."""
