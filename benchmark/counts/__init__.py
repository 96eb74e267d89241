"""Operations and bytes computed from shapes: the yardstick of the rooflines
and of the step's share of the card's peak."""
