from . import physics, terrain
from .adversarial import AdversarialWalker, WalkerParams, make_walker_env
from .env import WalkerState, gen_walker_obs, reset_walker, step_walker
