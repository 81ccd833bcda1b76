from . import bezier, dynamics, track
from .adversarial import (
    AdversarialCarRacing, CarRacingUEDParams, make_carracing_env,
)
from .env import CarRacingConfig, CarRacingState
from .track import Track, build_track
