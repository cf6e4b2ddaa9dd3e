"""One module a model family: its weight leaves and its plain float32
layers for the reference.  A configuration's ``family`` names it."""
