"""The yardstick's arithmetic: the card's published peaks
(:mod:`.peaks`), the analytic model FLOPs of each family
(:mod:`.flops`), and the least time a kernel's work needs on the card
(:mod:`.bounds`)."""
