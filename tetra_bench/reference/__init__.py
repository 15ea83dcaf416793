"""The plain reference that decides `correct`: the front end recomputed
from the raw air (frontend) and the receiver's answers against the air's
ground truth (truth).  It imports nothing of the program."""
