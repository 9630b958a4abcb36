from .fetch import Fetch
