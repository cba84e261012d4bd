"""Ring-road traffic environment constants (``repro.rl.env``).

Only the observation width is ported so far: the serving path needs it, and
the environment itself belongs to the training slice.
"""
OBS_DIM = 6
