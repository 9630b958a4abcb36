from .allegro import AllegroHandLeft, AllegroHandRight, AllegroHandRightTouch
